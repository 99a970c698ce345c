"""The port's flash-attention wrappers against ``edtr_tpu``'s Pallas
kernels (run in interpret mode on the CPU, as the JAX package's own tests
run them), and the port's dispatch against JAX's.

On the CPU a wrapper computes its kernel's plain version; on the card it
launches the hand-written kernel (tests/test_torch_kernels_card.py).
rtol = atol = 2e-3 in fp32, the tolerance of
tests/test_pipeline_and_kernels.py for the same kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.ops import flash_attention as JF
from edtr_torch.ops import attention as A
from edtr_torch.ops import flash_attention as F


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-3, atol=2e-3)

# (BH, N, D) flat shapes and the JAX flat function each wrapper replaces
CASES = [
    ("whole_fwd", (2, 512, 64), "_whole_fwd_flat"),
    ("wholekv_fwd", (1, 2048, 64), "_qblock_wholekv_fwd_flat"),
    ("streamkv_fwd", (1, 2048, 256), "_streamkv_fwd_flat"),
    ("streamkv_fwd", (1, 2048, 512), "_streamkv_fwd_flat"),  # the VAE mid-block's head dim
]


@pytest.mark.parametrize("name,shape,jax_fn", CASES)
def test_wrapper_matches_pallas_kernel(name, shape, jax_fn):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    o_j, lse_j = getattr(JF, jax_fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    assert F.kernel_for(shape[1], shape[2]) == name
    before = dict(F.launches)
    o_t, lse_t = F.FWD[name](*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert F.launches == before  # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)


def _jax_choice(monkeypatch, n, d):
    """Name of the flat function ``_fwd_flat_dispatch`` calls at (N, D)."""
    called = []
    for fn in ("_whole_fwd_flat", "_qblock_wholekv_fwd_flat", "_streamkv_fwd_flat",
               "_flash_fwd_flat"):
        monkeypatch.setattr(JF, fn, lambda *a, _fn=fn: called.append(_fn))
    x = jax.ShapeDtypeStruct((1, n, d), jnp.float32)
    JF._fwd_flat_dispatch(x, x, x, 1.0)
    return called[0]


_JAX_NAME = {"whole_fwd": "_whole_fwd_flat", "wholekv_fwd": "_qblock_wholekv_fwd_flat",
             "streamkv_fwd": "_streamkv_fwd_flat", "flash_fwd": "_flash_fwd_flat"}


@pytest.mark.parametrize("n", [64, 256, 512, 640, 1024, 1536, 2048, 3072, 4096,
                               5120, 8192, 16384])
@pytest.mark.parametrize("d", [30, 64, 128, 256, 512, 640])
def test_dispatch_matches_jax(n, d, monkeypatch):
    """Where JAX sends a call to a Pallas kernel, ``kernel_for`` names the
    same kernel (``_fwd_flat_dispatch``); the route sends a bf16 call there
    exactly where the port's kernel takes it (``kernel_takes``: D 64, or
    256-512), and every other call, JAX's XLA ones included, to the plain
    math."""
    def route(nq, nk, bias):
        q = torch.empty((1, nq, 2, d), device="meta", dtype=torch.bfloat16)
        kv = torch.empty((1, nk, 2, d), device="meta", dtype=torch.bfloat16)
        return A.kernel_route(q, kv, kv, bias)

    for nk, bias in ((n, None), (n + 512, None), (n, torch.empty(0))):
        jq = jax.ShapeDtypeStruct((1, n, 2, d), jnp.bfloat16)
        jkv = jax.ShapeDtypeStruct((1, nk, 2, d), jnp.bfloat16)
        jax_kernel = bias is None and JF.shapes_supported(jq, jkv, jkv)
        got = route(n, nk, bias)
        if jax_kernel:
            name = F.kernel_for(n, d)
            assert _JAX_NAME[name] == _jax_choice(monkeypatch, n, d), (n, d)
            takes = F.kernel_takes(name, torch.bfloat16, 2, n, d)
            assert got == (name if takes else None), (n, nk, d)
        else:
            assert got is None, (n, nk, d, bias is not None)


# (B, N, H, D) attention calls of the flagship (512², bs 1: UNet/ControlNet
# self-attention at 4096 and 1024 tokens, 64-dim heads; the VAE mid-block,
# one 512-dim head) and of the tiny flagship (64², 16-dim heads at 64 tokens
# and the VAE's one 64-dim head at 64), and shapes JAX's Pallas kernels take
# but the port's do not (D 128, 30)
ROUTE_SHAPES = [((1, 4096, 5, 64), "wholekv_fwd"), ((1, 1024, 10, 64), "whole_fwd"),
                ((1, 4096, 1, 512), "streamkv_fwd"), ((2, 4096, 1, 512), "streamkv_fwd"),
                ((1, 2048, 1, 384), "streamkv_fwd"), ((1, 8192, 5, 64), "flash_fwd"),
                ((1, 64, 2, 16), None), ((1, 64, 1, 64), None), ((1, 4096, 2, 128), None),
                ((1, 1024, 2, 30), None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,name", ROUTE_SHAPES)
def test_kernel_takes_decides_the_route(shape, name, dtype):
    """``kernel_takes`` against the route at the flagship's and the tiny
    dims' shapes: a bf16 call goes to the kernel JAX picks where the port's
    forward (and, at D 64, backward) kernels take it; an fp32 call, which
    JAX's Pallas kernels would run, and every shape they do not take, to the
    plain math."""
    b, n, h, d = shape
    q = torch.empty(shape, device="meta", dtype=dtype)
    want = name if dtype == torch.bfloat16 else None
    assert A.kernel_route(q, q, q) == want
    if name is not None:
        assert F.kernel_takes(name, dtype, b * h, n, d) == (dtype == torch.bfloat16)
        if d == 64:
            bwd = ("whole_bwd",) if n <= F.WHOLE_SEQ_MAX else ("flash_bwd_dq", "flash_bwd_dkv")
            assert all(F.kernel_takes(w, dtype, b * h, n, d) == (dtype == torch.bfloat16)
                       for w in bwd)
    assert not F.kernel_takes("streamkv_fwd", torch.bfloat16, b * h, n, 128)
    assert not F.kernel_takes("whole_fwd", torch.bfloat16, b * h, 1000, 64)


@pytest.mark.parametrize("bh,n,splits", [(1, 4096, 2), (2, 4096, 1), (1, 2048, 2),
                                         (2, 2048, 2), (4, 2048, 1), (1, 8192, 1)])
def test_streamkv_splits_fill_the_card(bh, n, splits):
    """K3 splits the KV range in two where its 64-row query blocks would
    leave more than half of an H100's 132 SMs idle (the restore's
    (1, 4096, 512): 64 blocks), and each split is a whole number of the
    kernel's K/V tiles (32 or 64 rows) at every N ``shapes_supported``
    admits (multiples of 512)."""
    assert F.streamkv_splits(bh, n) == splits
    assert bh * (n // 64) * splits <= 132 or splits == 1
    assert n % (64 * splits) == 0 and n % F._KERNEL["streamkv_fwd"][2] == 0


def test_cpu_calls_take_the_plain_math():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, 64)).astype(np.float32))
               for _ in range(3))
    assert A.kernel_route(q, k, v) is None  # fp32: no port kernel takes it
    assert A.kernel_route(*(t.to(torch.bfloat16) for t in (q, k, v))) == "whole_fwd"
    before = dict(F.launches)
    out = A.dot_product_attention(q, k, v)
    assert F.launches == before
    torch.testing.assert_close(out, A.plain_attention(q, k, v, 64 ** -0.5))
    flat = F.flash_attention(q, k, v, 64 ** -0.5)  # wrapper path, plain on CPU
    torch.testing.assert_close(flat, out, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [30, 64, 128])
def test_row_tile_divides_every_supported_n(d):
    """Every N that ``shapes_supported`` admits at D <= 128 (multiples of 128
    from 512, of 512 from 2048) is a multiple of the row tile of the kernel
    its wrapper launches, and that row tile of every wgmma plan's query rows
    (64 a block) and K/V tile."""
    admitted = []
    for n in range(64, 16385, 64):
        q = torch.empty((1, n, 2, d), device="meta")
        if F.shapes_supported(q, q, q):
            admitted.append(n)
            assert n % F._KERNEL[F.kernel_for(n, d)][2] == 0, n
    assert admitted[0] == 512 and 2048 in admitted and 8192 in admitted
    tile = F._KERNEL["wholekv_fwd"][2]
    for bn, _, _ in F.FLASH_PLANS:
        assert tile % 64 == 0 and tile % bn == 0


@pytest.mark.parametrize("name,bh,n,plan", [
    ("wholekv_fwd", 5, 4096, 0),   # K1, the restore
    ("wholekv_fwd", 10, 4096, 0),  # K1, the training step
    ("whole_fwd", 10, 1024, 1),    # K2, the restore: at most two blocks an SM
    ("whole_fwd", 20, 1024, 0),    # K2, the training step
    ("flash_fwd", 5, 8192, 0),     # K4, 1024²
])
def test_wrappers_launch_the_wgmma_kernel(name, bh, n, plan):
    """K1, K2 and K4 launch the wgmma kernel, in the plan the card measured
    faster at their shapes; K3 launches the streamed-KV wgmma kernel at the
    head dims JAX's ``_streamkv_fwd_flat`` takes (D > 128: 256, 384, 512)."""
    assert F.kernel_for(n, 64) == name
    assert F._KERNEL[name][:2] == ("edtr_flash_fwd_wgmma", (64,))
    assert F.flash_plan(bh, n) == plan
    assert F._KERNEL["streamkv_fwd"][:2] == ("edtr_flash_fwd_streamkv", (256, 384, 512))
    assert all(F.kernel_for(4096, d) == "streamkv_fwd" for d in (256, 384, 512))
