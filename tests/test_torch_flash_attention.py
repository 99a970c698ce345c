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

TOL = dict(rtol=2e-3, atol=2e-3)

# (BH, N, D) flat shapes and the JAX flat function each wrapper replaces
CASES = [
    ("whole_fwd", (2, 512, 64), "_whole_fwd_flat"),
    ("wholekv_fwd", (1, 2048, 64), "_qblock_wholekv_fwd_flat"),
    ("streamkv_fwd", (1, 2048, 256), "_streamkv_fwd_flat"),
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
    def route(nq, nk, bias):
        q = torch.empty((1, nq, 2, d), device="meta")
        kv = torch.empty((1, nk, 2, d), device="meta")
        return A.kernel_route(q, kv, kv, bias)

    for nk, bias in ((n, None), (n + 512, None), (n, torch.empty(0))):
        jq = jax.ShapeDtypeStruct((1, n, 2, d), jnp.float32)
        jkv = jax.ShapeDtypeStruct((1, nk, 2, d), jnp.float32)
        jax_kernel = bias is None and JF.shapes_supported(jq, jkv, jkv)
        got = route(n, nk, bias)
        assert (got is not None) == jax_kernel, (n, nk, d, bias is not None)
        if got is not None:
            assert _JAX_NAME[got] == _jax_choice(monkeypatch, n, d), (n, d)


def test_cpu_calls_take_the_plain_math():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, 64)).astype(np.float32))
               for _ in range(3))
    assert A.kernel_route(q, k, v) == "whole_fwd"
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
    faster at their shapes; K3 keeps the head-dim-512 kernel."""
    assert F.kernel_for(n, 64) == name
    assert F._KERNEL[name][:2] == ("edtr_flash_fwd_wgmma", 64)
    assert F.flash_plan(bh, n) == plan
    assert F._KERNEL["streamkv_fwd"][:2] == ("edtr_flash_fwd_d512", 512)
