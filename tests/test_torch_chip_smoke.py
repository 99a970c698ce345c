"""chip_smoke.py's rules that need no card: ``device_ms`` takes a trace only
with the call's own kernel count times the calls traced
(``trace_accepted``), and the shapes ``proj_bench.py`` times K3 and K10b at
are the restore's and the step's."""

import pytest

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
