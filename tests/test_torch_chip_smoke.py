"""chip_smoke.py's rules that need no card: ``device_ms`` takes a trace only
with the call's own kernel count times the calls traced
(``trace_accepted``), and the shapes ``proj_bench.py`` times K3 and K10b at
are the restore's and the step's."""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
import proj_bench


@pytest.mark.parametrize("kernels,launches,per_call,iters,ok", [
    (20, 20, 1, 20, True),    # one kernel a call, all there
    (40, 40, 2, 20, True),    # a two-kernel call (K11a, the F.linear x3 yardstick's pair)
    (60, 60, 3, 20, True),
    (20, 40, 2, 20, False),   # half of a two-kernel call's kernels lost: a multiple of iters
    (40, 60, 3, 20, False),   # a 3-kernel call that lost one a call (seen on the card)
    (0, 20, 1, 20, False),    # a trace that kept no kernel
    (19, 20, 1, 20, False),
    (20, 20, 2, 20, False),   # launches short of the call's own count
    (20, 20, 0, 20, False),   # the one-call trace recorded no launch
    (3, 3, 3, 1, True),
])
def test_device_ms_takes_only_the_exact_kernel_count(kernels, launches, per_call, iters, ok):
    assert chip_smoke.trace_accepted(kernels, launches, per_call, iters) is ok


def test_trace_stats_name_the_event_timed_calls():
    stats = chip_smoke.TRACE_STATS
    assert set(stats) == {"traces_taken_again", "event_timed", "event_timed_calls"}
    assert isinstance(stats["event_timed_calls"], list)


def test_bench_times_k3_and_k10b_at_the_restore_and_step_shapes():
    assert chip_smoke.KERNELS["streamkv_fwd"][0] == (1, 4096, 512)
    assert chip_smoke.KERNELS["streamkv_fwd"][3] == "edtr_torch/csrc/flash_streamkv.cuh"
    k3 = {k: v for k, v in proj_bench.FLASH_SHAPES.items() if k[0] == "streamkv_fwd"}
    assert k3 == {("streamkv_fwd", 1, 4096): ("restore", 2),
                  ("streamkv_fwd", 2, 4096): ("training step", 2)}
    assert proj_bench.FLASH_D["streamkv_fwd"] == 512
    assert {k[1]: n for k, (_, n) in proj_bench.POST_SHAPES.items()} == {1: 48, 2: 48}
    assert all(k[0] == "swin_post" and k[2:] == (64, 64, 180, 8, 360)
               for k in proj_bench.POST_SHAPES)


def test_bench_and_smoke_hold_k9_and_k7a_at_their_shapes():
    """``proj_bench.py --swin`` times K9 at the restore's 64 windows and the
    step's 128, each with and without the shift mask (24 + 24 launches of
    each); its projection set and chip_smoke hold K7a (on no path) at the
    flagship's three token levels, bs 1 and 2 and bs 1, on the wgmma
    projection kernel's source."""
    assert {k: v for k, v in proj_bench.WIN_SHAPES.items()} == {
        ("window_attention", bw, 64, 6, 30, nw): (per, 24)
        for bw, per in ((64, "restore"), (128, "training step")) for nw in (0, 64)}
    assert sum(n for per, n in proj_bench.WIN_SHAPES.values() if per == "restore") == (
        chip_smoke.SWIN_KERNELS["window_attention"][2])
    levels = {(4096, 320, 1280), (1024, 640, 2560), (256, 1280, 5120)}
    assert {k[2:] for k in proj_bench.GEGLU_SHAPES} == levels
    assert {k[1] for k in proj_bench.GEGLU_SHAPES} == {1, 2}
    assert {k[2:] for k in chip_smoke.GEGLU_HELD} == levels
    assert all(k[:2] == ("geglu_proj", 1) for k in chip_smoke.GEGLU_HELD)
    assert chip_smoke.PROJ_KERNELS["geglu_proj"][0] == "edtr_torch/csrc/proj_wgmma.cuh"
    assert chip_smoke.SWIN_KERNELS["window_attention"][0] == "edtr_torch/csrc/window_attention.cu"


def test_recipe_launches_are_sums_of_the_passes():
    """The recipes' exact launches are sums of per-pass counts that also sum
    to the training step's and the walk's (``recipe_launches`` checks both
    before it answers)."""
    diffbir = chip_smoke.recipe_launches("diffbir")
    steps = chip_smoke.DIFFBIR_STEPS
    assert diffbir["wholekv_fwd"] == diffbir["whole_fwd"] == 7 * (steps + 1) + 5
    assert diffbir["streamkv_fwd"] == 3  # two bs-2 encodes and the bs-1 decode
    assert all(diffbir[k] == 5 for k in ("whole_bwd", "flash_bwd_dq", "flash_bwd_dkv"))
    assert chip_smoke.recipe_launches("sr4ir")["swin_pre"] == 96
    for recipe in ("swinir_pre", "task_swinir"):
        got = chip_smoke.recipe_launches(recipe)
        assert {k: n for k, n in got.items() if n} == chip_smoke.SWINIR_PASS


@pytest.mark.parametrize("kp,pf,kf,ok", [
    (0.01, 0.02, 0.02, True),    # plain bf16 near fp32: kernel vs plain within 5e-2
    (0.06, 0.02, 0.05, False),
    (0.30, 0.28, 0.30, True),    # plain bf16 itself 0.28 from fp32: the control rule
    (0.30, 0.28, 0.31, False),
])
def test_gate_rule(kp, pf, kf, ok):
    assert chip_smoke.gate_rule(kp, pf, kf)[0] is ok


@pytest.mark.parametrize("helper,args,want", [
    ("eps_launches", (64, 64), chip_smoke.EPS_PASS),
    ("encode_launches", (512, 512), chip_smoke.ENCODE_PASS),
    ("decode_launches", (64, 64), chip_smoke.DECODE_PASS),
    ("swinir_launches", (512, 512), chip_smoke.SWINIR_PASS),
    # 768 x 1024: the 12288-token level goes to K4, 3072 to K1, 768 to K2;
    # the 12 x 16 level takes the whole-image conv tier, as 8² does
    ("eps_launches", (96, 128), {"flash_fwd": 7, "wholekv_fwd": 7, "whole_fwd": 7,
                                 "gn_conv_band": 42, "gn_conv_whole": 22, "upsample_conv": 3}),
    ("decode_launches", (96, 96), {"streamkv_fwd": 1, "gn_conv_band": 28, "upsample_conv": 3}),
    ("encode_launches", (256, 256), {"gn_conv_band": 20}),  # 1024 tokens: JAX's XLA path
])
def test_pass_launch_helpers(helper, args, want):
    """The per-pass launch helpers derive the pinned 512² passes from JAX's
    dispatch, and the demo's other sizes."""
    assert getattr(chip_smoke, helper)(*args) == want


def test_demo_launches_are_tiles_times_passes():
    """The untiled demo at 768 x 1024 is a 512² restore plus K4's 28; the
    tiled one is each tile plan's tiles times the launches of a pass at
    its tile: 6 SwinIR tiles, 12 + 20 encoder tiles, 6 latent tiles x 4
    steps, 2 + 2 decoder tiles (6 detector tiles launch none)."""
    untiled = chip_smoke.demo_launches(768, 1024, tiled=False)
    restore = chip_smoke.demo_launches(512, 512, tiled=False)
    assert untiled == dict(restore, flash_fwd=28)
    assert restore == {k: v or 0 for k, v in chip_smoke.expected_launches(
        (True, False, True)).items()}
    tiles = chip_smoke.tile_counts(768, 1024)
    assert tiles == dict(swinir=6, vae_encoder=(12, 20), latent=6, vae_decoder=(2, 2), detect=6)
    want = chip_smoke.launch_sum(
        (6, chip_smoke.SWINIR_PASS), (32, chip_smoke.encode_launches(256, 256)),
        (24, chip_smoke.EPS_PASS), (4, chip_smoke.decode_launches(96, 96)))
    assert chip_smoke.demo_launches(768, 1024, tiled=True) == want
    assert want["flash_fwd"] == 0 and want["streamkv_fwd"] == 4 and want["wholekv_fwd"] == 168


@pytest.fixture
def rehearsal(monkeypatch):
    """chip_smoke on the CPU at 64²: the card's clock, memory and trace calls
    stubbed, every launch count 0 (the plain versions launch no kernel), the
    tiny flagship with a 49408-token text tower for the configs' pipelines,
    the configs' SwinIR in fp32."""
    import torch

    from edtr_torch.models.cldm import clip_from_cfg
    from edtr_torch.models.layers import randomize_
    from edtr_torch.pipeline import build_flagship, flagship_configs, swinir_from_config

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in ("synchronize", "reset_peak_memory_stats", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "IMAGE", 64)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, iters, warmup=2, what="": (fn(), 0.0)[1])
    zeros = {k: 0 for k in chip_smoke.read_counts()[0]}
    monkeypatch.setattr(chip_smoke, "recipe_launches", lambda name: dict(zeros))
    monkeypatch.setattr(chip_smoke, "expected_launches", lambda flags: dict(zeros))
    monkeypatch.setattr(chip_smoke, "hold_shapes", lambda device, shapes: {})

    def trace(chain, iters, stages):
        chain()
        return {"stages": {s: dict(host_ms=0.0, device_busy_ms=0.0, idle_share=None, kernels=0,
                                   htod_memcpy=0, dtoh_memcpy=0) for s in stages}}
    monkeypatch.setattr("edtr_torch.profile_restore.trace_restores", trace)
    pipe = build_flagship(tiny=True, dtype=None, device="cpu")
    clip = flagship_configs(tiny=True)["clip"]
    pipe.cldm.clip = clip_from_cfg(dict(clip, text_cfg=dict(clip["text_cfg"], vocab_size=49408)))
    randomize_(pipe, torch.Generator().manual_seed(0)).eval()

    def config_pipeline(path, weights, device):
        from edtr_torch.config import load_config

        return load_config(path), pipe
    monkeypatch.setattr(chip_smoke, "config_pipeline", config_pipeline)
    monkeypatch.setattr(chip_smoke, "recipe_swinir",
                        lambda cfg, weights, device: swinir_from_config(cfg.model.swinir,
                                                                        device=device))

    yield torch.device("cpu")
    torch.set_num_threads(n)


def test_data_train_phase_rehearses_on_the_cpu(rehearsal, monkeypatch):
    """Phase 27 at bs 4 on a 9-image COCO tree: the loader's batch, the
    transform's stages recomputed on a second CPU run at their tolerances,
    GT/LQ in [0, 1], three SwinIR-pre steps with finite losses."""
    monkeypatch.setattr(chip_smoke, "DATA_COCO_IMAGES", 9)
    monkeypatch.setattr(chip_smoke, "DATA_COCO_SIDES", (80, 112))
    res = chip_smoke.data_train_phase({}, rehearsal, batch_size=4, gt_size=64)
    assert res["batch"] == 4 and res["dataset"] == 8 and res["steps"] == 3
    assert res["transform_dtoh_memcpy"] == 0 and len(res["losses"]) == 3
    assert res["card_vs_cpu"]["stages"] >= 8 and res["lq_gt_mean_abs"] > 1e-3
    assert set(res["card_vs_cpu"]["max_abs_by_stage"]) >= {"filter2d", "resize", "diff_jpeg"}
    assert set(res["op_device_ms"]) == {"usm", "filter2d_21", "resize_down_bicubic",
                                        "resize_back_bicubic"}


def test_data_eval_phase_rehearses_on_the_cpu(rehearsal, monkeypatch):
    """Phase 28 on a 3-image VOC tree at 64²: generated pairs, restored and
    detected, the 12 COCO stats."""
    monkeypatch.setattr(chip_smoke, "DATA_VOC_IMAGES", 3)
    monkeypatch.setattr(chip_smoke, "DATA_VOC_SIDES", (80, 112))
    res = chip_smoke.data_eval_phase({}, rehearsal, gt_size=64,
                                     detector_kw=dict(min_size=128, max_size=128))
    assert res["images"] == 3 and len(res["coco_stats"]) == 12
    assert all(-1 <= v <= 1 for v in res["coco_stats"].values())
    assert res["launches"] == {k: 0 for k in res["launches"]}


def test_runner_phase_rehearses_on_the_cpu(rehearsal, monkeypatch):
    """Phase 29 at the tiny widths on an 8-image VOC tree at 64², the batch
    2 as 2 microbatches, no loader workers (forking this multi-threaded
    test process could hang them; the card's run forks its config's 16):
    the four CLI runs, the resumed train state bit-identical and one step,
    image 0's detections equal to a direct restore + detect, the files and
    stats checked."""
    import yaml

    from edtr_torch.train import runner
    from test_torch_runner import shrink

    monkeypatch.setattr(runner, "DTYPE", None)
    monkeypatch.setattr(runner, "IMG_SIZE", 64)
    monkeypatch.setattr(runner, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "runner_launches",
                        lambda run, sizes=(): {k: 0 for k in chip_smoke.read_counts()[0]})
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def edit(path):
        with open(path) as f:
            cfg = shrink(yaml.safe_load(f))
        if "train" in cfg:
            cfg["train"].update(batch_size=2, num_workers=0)
            if "accum_steps" in cfg["train"]:
                cfg["train"]["accum_steps"] = 2
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    res = chip_smoke.runner_phase(rehearsal, n_images=8, sides=(72, 96), edit=edit)
    assert set(res) == {"data_s", "train", "resume", "test", "seg_swinir"}
    assert res["resume"]["restored_bit_identical"] == sorted(
        ["pipe", "detnet", "teacher_detnet", "tx_edtr", "tx_detnet", "schedule",
         "schedule_detnet"])
    assert res["test"]["image0_equal_direct"] and len(res["train"]["val"]) == 2
    assert res["train"]["bytes_written"] > res["resume"]["bytes_written"] >= 0
    assert all(np.isfinite(v) for v in res["train"]["losses"].values())
