"""edtr_torch's kernel wrappers on the card: a CUDA tensor at a supported
shape launches the hand-written kernel (its launch count rises by one), and
one no kernel takes raises. (``chip_smoke.py`` holds each kernel against its
plain version.)
The kernels have no CPU mode: without a card this test skips. This file
imports no JAX, so on a card host without JAX it runs alone, without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_card.py
"""

import pytest
import torch

from edtr_torch.ops import attention as A
from edtr_torch.ops import flash_attention as F
from edtr_torch.ops import gn_conv as G


@pytest.mark.cuda
def test_cuda_call_launches_or_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q = torch.randn((1, 1024, 2, 64), device="cuda", dtype=torch.bfloat16)
    before = F.launches["whole_fwd"]
    A.dot_product_attention(q, q, q)
    assert F.launches["whole_fwd"] == before + 1
    with pytest.raises(ValueError):  # fp32 at a supported shape: no kernel takes it
        A.dot_product_attention(q.float(), q.float(), q.float())


def _conv_args(cin=64, cout=64, h=8):
    def rnd(*shape):
        return torch.randn(shape, device="cuda")
    x = rnd(1, cin, h, h).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return x, rnd(1, cin), rnd(1, cin), rnd(cout, cin, 3, 3) * 0.05, rnd(cout)


@pytest.mark.cuda
@pytest.mark.parametrize("name,h", [("gn_conv_whole", 8), ("gn_conv_band", 16),
                                    ("upsample_conv", 8)])
def test_conv_call_launches(name, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, mul, add, w, b = _conv_args(h=h)
    before = G.launches[name]
    if name == "upsample_conv":
        out = G.upsample_conv(x, w, b, "lrelu")
        assert out.shape == (1, 64, 2 * h, 2 * h)
    else:
        emb = torch.randn((1, 64), device="cuda", dtype=torch.bfloat16)
        out = G.gn_silu_conv(x, mul, add, w, b, emb, torch.zeros_like(x))
        assert out.shape == x.shape
    torch.cuda.synchronize()
    assert G.launches[name] == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
def test_conv_unsupported_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, mul, add, w, b = _conv_args()
    with pytest.raises(ValueError):  # fp32 activations: no kernel takes them
        G.gn_silu_conv(x.float(), mul, add, w, b)
    with pytest.raises(ValueError):  # Cin 48: not a multiple of 32
        G.gn_silu_conv(x[:, :48], mul[:, :48], add[:, :48], w[:, :48], b)
    with pytest.raises(ValueError):  # Cout 96: not a multiple of 64
        G.upsample_conv(x, torch.cat([w, w[:32]]), torch.cat([b, b[:32]]))
