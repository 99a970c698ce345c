"""The trace summary of ``edtr_torch.profile_restore`` on a synthetic
Chrome trace: stage attribution by launch time, device-busy union, idle
share, host-to-device copies and kernel families."""

import pytest

from edtr_torch.profile_restore import _family, summarise


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_summarise_attributes_kernels_to_the_launching_stage():
    events = [
        _x("user_annotation", "swinir", 0, 100),
        _x("user_annotation", "vae_encode", 100, 100),
        _x("user_annotation", "scan", 200, 100),
        _x("user_annotation", "decode+wavelet", 300, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 1, corr=3),
        # launched in swinir, overlapping: union 30..80 = 50 us
        _x("kernel", "void at::native::vectorized_elementwise_kernel", 30, 40, corr=1),
        _x("kernel", "sm90_xmma_gemm_bf16", 50, 30, corr=2),
        # launched in scan, runs past the range end: still scan's
        _x("kernel", "flash_wgmma_kernel", 290, 20, corr=3),
    ]
    out = summarise({"traceEvents": events})
    sw, scan = out["stages"]["swinir"], out["stages"]["scan"]
    assert sw["kernels"] == 2 and abs(sw["device_busy_ms"] - 0.05) < 1e-9
    assert abs(sw["idle_share"] - 0.5) < 1e-9
    assert scan["kernels"] == 1 and abs(scan["device_busy_ms"] - 0.02) < 1e-9
    assert out["stages"]["vae_encode"]["kernels"] == 0
    assert out["kernels_per_restore"] == 3
    assert abs(out["device_ms_per_restore"] - 0.09) < 1e-9
    assert set(out["by_family_ms"]) == {"elementwise / copy", "gemm (cuBLAS)",
                                        "flash (edtr_torch)"}


def test_kernel_families():
    assert (_family("void edtr_streamkv::streamkv_kernel<512>(CUtensorMap_st, "
                    "CUtensorMap_st, CUtensorMap_st, edtr_streamkv::Args)")
            == "flash (edtr_torch)")
    # the port's conv kernel, not cuDNN, though its name holds "conv"
    assert (_family("void edtr_gnconv::gnconv_wgmma_kernel<128, false>(CUtensorMap_st, "
                    "CUtensorMap_st, edtr_gnconv::Args)") == "gn_conv (edtr_torch)")
    assert _family("sm90_xmma_fprop_implicit_gemm_bf16") == "conv (cuDNN)"
    assert _family("ampere_bf16_s16816gemm_bf16_128x64") == "gemm (cuBLAS)"
    assert _family("void at::native::reduce_kernel<512>") == "norm / reduce"
    assert _family("something_else") == "other"


def test_profile_books_the_swin_kernels_and_counts_host_copies():
    for name in ("void (anonymous namespace)::window_attention_kernel(...)",
                 "void (anonymous namespace)::swin_pre_kernel((anonymous namespace)::PreArgs)",
                 "void (anonymous namespace)::swin_post_kernel<32>((anonymous namespace)::"
                 "PostArgs)"):
        assert _family(name) == "swin (edtr_torch)", name

    def ev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}
    events = [ev("user_annotation", s, 100 * i, 100, None)
              for i, s in enumerate(("swinir", "vae_encode", "scan", "decode+wavelet"))]
    events += [ev("cuda_runtime", "cudaMemcpyAsync", 10, 1, 1),
               ev("cuda_runtime", "cudaLaunchKernel", 20, 1, 2),
               ev("cuda_runtime", "cudaMemcpyAsync", 210, 1, 3),
               ev("cuda_runtime", "cudaMemcpyAsync", 220, 1, 4),
               ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30, 5, 1),
               ev("kernel", "swin_pre_kernel", 40, 5, 2),
               # issued in scan, runs after its range: still scan's
               ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 305, 5, 3),
               ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 310, 5, 4)]
    stages = summarise({"traceEvents": events})["stages"]
    assert {s: v["htod_memcpy"] for s, v in stages.items()} == {
        "swinir": 1, "vae_encode": 0, "text": 0, "scan": 1, "decode+wavelet": 0}
    assert {s: v["dtoh_memcpy"] for s, v in stages.items()} == {
        "swinir": 0, "vae_encode": 0, "text": 0, "scan": 1, "decode+wavelet": 0}
    assert stages["swinir"]["kernels"] == 1


def test_profile_books_the_backward_kernels_and_takes_a_train_step():
    from edtr_torch.profile_restore import TRAIN_STAGES

    for name in ("void edtr_flash_bwd::flash_dq_wgmma_kernel<64, 3, 3>(CUtensorMap_st, ...)",
                 "void edtr_flash_bwd::flash_dkv_wgmma_kernel<64, 4, 1, true>(...)"):
        assert _family(name) == "flash (edtr_torch)", name
    events = []
    for run in range(2):  # two steps without a detnet: no sample range
        t0 = 1000 * run
        events += [_x("user_annotation", s, t0 + 100 * i, 100)
                   for i, s in enumerate(("forward+loss", "backward", "optimizer"))]
        events += [_x("cuda_runtime", "cudaLaunchKernel", t0 + 10, 1, corr=10 * run + 1),
                   _x("cuda_runtime", "cudaLaunchKernel", t0 + 110, 1, corr=10 * run + 2),
                   _x("cuda_runtime", "cudaLaunchKernel", t0 + 120, 1, corr=10 * run + 3),
                   _x("cuda_runtime", "cudaLaunchKernel", t0 + 210, 1, corr=10 * run + 4),
                   _x("kernel", "flash_wgmma_kernel", t0 + 20, 30, corr=10 * run + 1),
                   _x("kernel", "flash_dq_wgmma_kernel<64, 3, 3>", t0 + 130, 20, corr=10 * run + 2),
                   _x("kernel", "flash_dkv_wgmma_kernel<64, 4, 1>", t0 + 150, 30, corr=10 * run + 3),
                   _x("kernel", "multi_tensor_apply_kernel", t0 + 220, 10, corr=10 * run + 4)]
    out = summarise({"traceEvents": events}, TRAIN_STAGES)
    assert set(out["stages"]) == set(TRAIN_STAGES)
    assert {s: out["stages"][s]["kernels"] for s in TRAIN_STAGES} == {
        "forward+loss": 1, "sample": 0, "backward": 2, "optimizer": 1}
    bwd = out["stages"]["backward"]
    assert abs(bwd["device_busy_ms"] - 0.05) < 1e-9 and abs(bwd["idle_share"] - 0.5) < 1e-9
    assert abs(out["by_family_ms"]["flash (edtr_torch)"] - 0.08) < 1e-9
    assert out["kernels_per_restore"] == 4


@pytest.mark.parametrize("name,family", [
    # the port's kernels, as the profiler names them; "conv" and "gemm" in
    # some of them, but not cuDNN's or cuBLAS's
    ("void edtr_gnconv::gnconv_wgmma_kernel<128, false>(CUtensorMap_st, CUtensorMap_st, "
     "edtr_gnconv::Args)", "gn_conv (edtr_torch)"),
    ("void edtr_gnconv::gnconv_wgmma_kernel<32, true>(CUtensorMap_st, CUtensorMap_st, "
     "edtr_gnconv::Args)", "gn_conv (edtr_torch)"),
    ("edtr_upconv::upconv_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, edtr_upconv::UpArgs)",
     "gn_conv (edtr_torch)"),
    ("void edtr_lnproj::lnproj_kernel<64, 160, 1, 2>(CUtensorMap_st, CUtensorMap_st, "
     "edtr_lnproj::Args)", "proj (edtr_torch)"),
    ("void edtr_lnproj::lnproj_kernel<128, 128, 2, 1>(CUtensorMap_st, CUtensorMap_st, "
     "edtr_lnproj::Args)", "proj (edtr_torch)"),
    # cuDNN's and cuBLAS's, which the stock path runs
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv (cuDNN)"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<true>", "conv (cuDNN)"),
    ("nvjet_tst_64x64_64x13_4x2_h_bz_TNT", "gemm (cuBLAS)"),
])
def test_kernel_families_of_the_port_and_the_libraries(name, family):
    assert _family(name) == family


def test_summarise_books_the_detect_stage():
    """A restore-and-detect trace (``RESTORE_DETECT_STAGES``): the detect
    range's kernels and copies are its own, and the detector's sorts book
    as the sort family."""
    from edtr_torch.profile_restore import RESTORE_DETECT_STAGES

    assert RESTORE_DETECT_STAGES == ("swinir", "vae_encode", "text", "scan",
                                     "decode+wavelet", "detect")
    events = [_x("user_annotation", s, 100 * i, 100)
              for i, s in enumerate(RESTORE_DETECT_STAGES)]
    at = 100 * RESTORE_DETECT_STAGES.index("detect")  # the detect range's start
    events += [_x("cuda_runtime", "cudaLaunchKernel", at + 10, 1, corr=1),
               _x("cuda_runtime", "cudaLaunchKernel", at + 20, 1, corr=2),
               _x("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", at + 30,
                  10, corr=1),
               _x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", at + 45, 20, corr=2)]
    out = summarise({"traceEvents": events}, RESTORE_DETECT_STAGES)
    det = out["stages"]["detect"]
    assert det["kernels"] == 2 and abs(det["device_busy_ms"] - 0.03) < 1e-9
    assert det["htod_memcpy"] == 0 and abs(det["idle_share"] - 0.7) < 1e-9
    assert out["stages"]["swinir"]["kernels"] == 0
    assert set(out["by_family_ms"]) == {"sort / top-k", "conv (cuDNN)"}
