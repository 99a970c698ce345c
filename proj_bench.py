#!/usr/bin/env python3
"""Time the projection kernels K8a (``ln_matmul.ln_matmuls``), K8b
(``ln_matmul.affine_matmul``) and K7b (``geglu.ln_geglu_proj``) at every
shape of the 512² fused+proj restore and K7a (``geglu.geglu_proj``, on no
path) at the flagship's three token levels at bs 1 and 2, with ``--conv``
the conv kernels
K5a/K5b (``gn_conv.gn_silu_conv``: ``gn_conv_whole``, ``gn_conv_band``) and
K6 (``gn_conv.upsample_conv``) at every shape of the fused restore, with
``--flash`` the flash forward wrappers (K1 ``wholekv_fwd``, K2
``whole_fwd``, K4 ``flash_fwd`` at head dim 64, K3 ``streamkv_fwd`` at 512)
at the restore's and the bs-2 training step's shapes, with ``--swin`` K10a
(``swin_block.swin_pre``) at the fused+swin restore's, K10b
(``swin_block.swin_post``) and K9 (``window_attention``, with and without
the shift mask) at the restore's and the step's, and with
``--flash-bwd`` the flash backward wrappers
(K11a ``whole_bwd``, K11b ``flash_bwd_dq``, K11c ``flash_bwd_dkv``) at the
bs-2 training step's shapes, on one NVIDIA GPU.

    python3 proj_bench.py [--rounds R] [--plans] [--conv] [--flash] [--swin]
                          [--flash-bwd]

Run it from the root of a checkout: it builds that checkout's sources and
calls that checkout's ``chip_smoke.proj_case`` at each projection shape
(kernel against its plain version, with chip_smoke's error gates; device
ms of the kernel, of ``F.linear`` on the already-transformed bf16 tokens
and of the plain version; the bound). The conv kernels are held here
against their plain versions with chip_smoke's conv gates (K6 with the
weights in the form that checkout's kernel reads) and timed the same way:
device ms from a trace, so that the host's launch time does not count, and
``F.conv2d`` on the activated (K5) or upsampled (K6) bf16 input; the 9-tap
(K5) or 4-tap (K6) bound. ``--rounds`` repeats the shape walk, so that two
checkouts timed in one call can be timed in turns (parent, change, change,
parent). ``--plans`` also times each projection kernel at other tile plans
(``ops/_proj.py:lnproj_plan``'s (bm, bn, groups), K7a's 128-row blocks
among them) than the one the wrapper picks, and with ``--conv`` each K5
shape at the other tiles
(``gn_conv.GN_TILES``) the kernel takes, and with ``--flash`` each D-64
flash shape in every plan of ``flash_attention.FLASH_PLANS`` and K3 with
its KV range whole and split in two (``flash_attention.streamkv_splits``),
and with ``--swin`` each ``swin_post`` and K9 shape at one and two blocks
a window (``swin_block.post_split``, ``window_attention.window_split``).
With ``--flash``, ``--swin`` or
``--flash-bwd`` the projection shapes are left out. The flash, Swin and
backward kernels are held to chip_smoke's gates, two calls bit-identical,
and timed on the same trace clock (``flash_shape``, ``swin_shape``,
``post_shape``, ``bwd_shape``; K9 through ``chip_smoke.swin_case``), with
SDPA (its backward alone for K11; with the bias and mask as one additive
mask for K9) and ``F.linear`` as the yardsticks; all run in a checkout from
before these
flags (copy this script and ``chip_smoke.py`` into it: ``swin_shape`` and
``post_shape`` hand its kernels the weight form they read; ``bwd_shape``
calls only the wrappers both have).

Prints one ``proj shape:`` (``conv shape:``, ``flash shape:``, ``swin
shape:``, ``bwd shape:``) JSON line per shape and round, then a ``proj
summary:`` line per kernel: the launch-weighted device ms per restore (the
flash wrappers also per training step, the backward ones only; K4 one
call), the sums of chip_smoke's ``kernels`` line, with the card's
``nvidia-smi`` name and power limit, and last the count of ``device_ms``
traces taken again and of calls it timed by CUDA events, with their names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the fused+proj 512² restore's K8a/K8b/K7b launches per shape: 4 steps x
# (UNet 5 + ControlNet 2) transformer blocks at each of 4096, 1024 and 256
# tokens, each one GroupNorm-affine + proj_in, one LN + q/k/v (K = 3), one
# LN + query (K = 1) and one LN + GEGLU; keys as ``ln_matmul.shapes`` /
# ``geglu.shapes`` log them
TOKENS = ((4096, 320), (1024, 640), (256, 1280))
RESTORE_SHAPES = {
    **{("ln_matmuls", 1, n, c, c, k): 28 for n, c in TOKENS for k in (1, 3)},
    **{("affine_matmul", 1, n, c, c, 1): 28 for n, c in TOKENS},
    **{("ln_geglu_proj", 1, n, c, 4 * c): 28 for n, c in TOKENS},
}
# K7a (``geglu_proj``, a FeedForward without ``pre_norm``: on no path of the
# flagship) at JAX's supported shapes of the three token levels, bs 1 and 2,
# one call each (``geglu.shapes`` keys: wrapper, B, N, C, inner)
GEGLU_SHAPES = {("geglu_proj", b, n, c, 4 * c): ("one call", 1) for n, c in TOKENS
                for b in (1, 2)}
# the fused 512² restore's K6 launches per shape (``gn_conv.shapes`` keys:
# wrapper, B, Cin, output H, W, Cout, emb, res, act): the UNet decoder's 3
# upsamples in each of 4 steps, the VAE decoder's 3, the SwinIR tail's 3
CONV_SHAPES = {
    ("upsample_conv", 1, 1280, 16, 16, 1280, False, False, None): 4,
    ("upsample_conv", 1, 1280, 32, 32, 1280, False, False, None): 4,
    ("upsample_conv", 1, 640, 64, 64, 640, False, False, None): 4,
    ("upsample_conv", 1, 512, 128, 128, 512, False, False, None): 1,
    ("upsample_conv", 1, 512, 256, 256, 512, False, False, None): 1,
    ("upsample_conv", 1, 256, 512, 512, 256, False, False, None): 1,
    **{("upsample_conv", 1, 64, h, h, 64, False, False, "lrelu"): 1 for h in (128, 256, 512)},
}
CONV_NAMES = ("gn_conv_whole", "gn_conv_band", "upsample_conv")


def _k5(cin, hw, cout, emb, res):
    return ("gn_conv_whole" if hw < 16 else "gn_conv_band", 1, cin, hw, hw, cout, emb, res,
            None)


# the fused 512² restore's K5 launches per shape (``gn_conv.shapes`` keys,
# which chip_smoke.py holds to these): a ResBlock is two launches, the
# first adding emb (UNet, ControlNet), the second the skip. 4 steps x (UNet
# 22 + ControlNet 10 ResBlocks): at 8² (K5a) the UNet's 2 input, 2 middle
# and 3 output blocks and the ControlNet's 2 + 2; at 16²-64² 2 input blocks
# each (both nets) and the UNet's 3 output blocks (their inputs concatenate
# a skip). The VAE's encoder (10 ResBlocks) and decoder (14) at 64²-512².
# The training step (bs 2) launches the same shapes with B = 2.
GN_SHAPES = {
    _k5(1280, 8, 1280, True, False): 32, _k5(1280, 8, 1280, False, True): 44,
    _k5(2560, 8, 1280, True, False): 12,
    _k5(640, 16, 1280, True, False): 8, _k5(1280, 16, 1280, False, True): 28,
    _k5(1280, 16, 1280, True, False): 8, _k5(2560, 16, 1280, True, False): 8,
    _k5(1920, 16, 1280, True, False): 4,
    _k5(320, 32, 640, True, False): 8, _k5(640, 32, 640, False, True): 28,
    _k5(640, 32, 640, True, False): 8, _k5(1920, 32, 640, True, False): 4,
    _k5(1280, 32, 640, True, False): 4, _k5(960, 32, 640, True, False): 4,
    _k5(320, 64, 320, True, False): 16, _k5(320, 64, 320, False, True): 28,
    _k5(960, 64, 320, True, False): 4, _k5(640, 64, 320, True, False): 8,
    _k5(512, 64, 512, False, False): 9, _k5(512, 64, 512, False, True): 9,
    _k5(256, 128, 512, False, False): 1, _k5(512, 128, 512, False, True): 5,
    _k5(512, 128, 512, False, False): 4,
    _k5(128, 256, 256, False, False): 1, _k5(256, 256, 256, False, True): 5,
    _k5(256, 256, 256, False, False): 3, _k5(512, 256, 256, False, False): 1,
    _k5(128, 512, 128, False, False): 4, _k5(128, 512, 128, False, True): 5,
    _k5(256, 512, 128, False, False): 1,
}


# the flash forward wrappers' launches per shape (wrapper, BH, N; head dim
# 64, streamkv_fwd 512): the 512² restore's (bs 1: 4 steps x (UNet 5 +
# ControlNet 2) self-attentions at 4096 and at 1024 tokens, 5 and 10 heads;
# the VAE encoder's and decoder's mid-block attention, one head of 512) and
# the bs-2 training step's (its forward once plus the remat recompute: 12
# at each; the VAE's 2); K4 (N > 4096) runs only at 1024², held at one call
FLASH_SHAPES = {
    ("wholekv_fwd", 5, 4096): ("restore", 28), ("whole_fwd", 10, 1024): ("restore", 28),
    ("wholekv_fwd", 10, 4096): ("training step", 12),
    ("whole_fwd", 20, 1024): ("training step", 12),
    ("flash_fwd", 5, 8192): ("one call", 1),
    ("streamkv_fwd", 1, 4096): ("restore", 2), ("streamkv_fwd", 2, 4096): ("training step", 2),
}
FLASH_D = {"streamkv_fwd": 512}  # head dim of a wrapper's shapes (else 64)
# the flash backward wrappers' launches per shape (wrapper, BH, N; head dim
# 64) in the bs-2 training step: every ControlNet self-attention and the
# UNet's output blocks', 2 + 3 at 1024 tokens (10 heads x 2) and 2 + 3 at
# 4096 (5 heads x 2); chip_smoke.py holds the step to these
BWD_SHAPES = {("whole_bwd", 20, 1024): 5, ("flash_bwd_dq", 10, 4096): 5,
              ("flash_bwd_dkv", 10, 4096): 5}
# the backward products each wrapper's function needs (whole: S, dP, dV, dQ,
# dK; dq: S, dP, dQ; dkv: S, dP, dV, dK), for the bound, and the
# gradients it returns (of dq, dk, dv)
BWD_PRODUCTS = {"whole_bwd": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
BWD_OUTS = {"whole_bwd": (0, 1, 2), "flash_bwd_dq": (0,), "flash_bwd_dkv": (1, 2)}
# the fused+swin 512² restore's swin_pre launches per shape
# (``swin_block.shapes`` keys: wrapper, B, h, w, C, window, d): 8 RSTBs of 6
# blocks at 64 x 64 tokens, d = shift - in_offset: 0 for the first block of
# each, then 4 (the shifted blocks) and -4 (the unshifted ones after them);
# chip_smoke.py holds the restore to these
SWIN_SHAPES = {("swin_pre", 1, 64, 64, 180, 8, 0): 8, ("swin_pre", 1, 64, 64, 180, 8, 4): 24,
               ("swin_pre", 1, 64, 64, 180, 8, -4): 16}
# swin_post's launches per shape (``swin_block.shapes`` keys: wrapper, B, h,
# w, C, window, hidden): each of the 48 blocks of the restore (bs 1) and of
# the training step (bs 2, SwinIR's forward under no grad)
POST_SHAPES = {("swin_post", 1, 64, 64, 180, 8, 360): ("restore", 48),
               ("swin_post", 2, 64, 64, 180, 8, 360): ("training step", 48)}
# K9's launches per shape (``window_attention.shapes`` keys: wrapper, BW, N,
# H, D, mask windows, 0 without the mask): the 48 blocks of the restore (64
# windows) and of the training step (128), half of them shifted (masked)
WIN_SHAPES = {("window_attention", bw, 64, 6, 30, nw): (per, 24)
              for bw, per in ((64, "restore"), (128, "training step")) for nw in (0, 64)}


def flash_shape(device, key, gen) -> dict:
    """A flash forward wrapper at (wrapper, BH, N), D 64: held against
    ``plain_fwd`` with chip_smoke's gates; device ms of the kernel, of the
    plain version and of SDPA (a yardstick the port never calls), the
    kernel's CUDA-event ms, and the bound."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import flash_attention as FA

    name, bh, n = key
    d = FLASH_D.get(name, 64)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=device, dtype=torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    fwd = FA.FWD[name]
    (o, lse), (o_2, lse_2) = fwd(q, k, v, scale), fwd(q, k, v, scale)
    o_p, lse_p = FA.plain_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    same = bool(torch.equal(o, o_2) and torch.equal(lse, lse_2))
    err = (o.float() - o_p.float()).abs().max().item()
    o_max = o_p.float().abs().max().item()
    rel = chip_smoke.rel_l2(o, o_p)
    err_lse = (lse - lse_p).abs().max().item()
    chip_smoke.check(err <= chip_smoke.TOL_O_MAX * o_max and rel <= chip_smoke.TOL_O_L2
                     and err_lse <= chip_smoke.TOL_LSE and same,
                     f"{key} vs plain: max abs {err}, rel L2 {rel}, lse {err_lse}, "
                     f"bit-identical twice: {same}")
    q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
    t_ops = 4.0 * n * n * d * bh / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = (4 * bh * n * d * 2 + bh * n * 4) / chip_smoke.PEAK_BYTES * 1e3
    what = f"{name} {(bh, n, d)}"
    return dict(ms=chip_smoke.device_ms(lambda: fwd(q, k, v, scale), 20, what=what),
                plain_ms=chip_smoke.device_ms(lambda: FA.plain_fwd(q, k, v, scale), 3, 1,
                                              what=f"plain {what}"),
                library_ms=chip_smoke.device_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), 20,
                    what=f"SDPA {what}"),
                event_ms=chip_smoke.time_ms(lambda: fwd(q, k, v, scale), 20),
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_err_share=err / o_max, rel_l2=rel, err_lse=err_lse, same_twice=same)


def bwd_shape(device, key, gen) -> dict:
    """A flash backward wrapper at (wrapper, BH, N), D 64, on the (q, k, v,
    O, lse) of a forward and a random dO: held against ``plain_bwd`` with
    chip_smoke's gates (each gradient it returns), called twice for
    bit-identical gradients, launching its kernel once a call; device ms of
    the wrapper, of ``plain_bwd`` and of SDPA's backward alone (all three
    gradients, from a retained graph; a yardstick the port never calls), the
    CUDA-event ms of the wrapper and of SDPA's backward, and the bound: the
    products of the function the wrapper computes, not a split design's
    recomputes, and each input read and output written once."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import flash_attention as FA

    name, bh, n = key
    d = 64
    q, k, v, do = (torch.randn((bh, n, d), generator=gen, device=device, dtype=torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = FA.FWD[FA.kernel_for(n, d)](q, k, v, scale)
    dd = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, dd, scale)
    fn = getattr(FA, name)
    before = FA.launches[name]
    got, again = fn(*args), fn(*args)
    chip_smoke.check(FA.launches[name] == before + 2, f"{name} launched its kernel once a call")
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = FA.plain_bwd(*args)
    torch.cuda.synchronize()
    errors = {}
    for i, a, b in zip(BWD_OUTS[name], got, again):
        w = want[i].float()
        errors["dq dk dv".split()[i]] = dict(
            max_abs_err=(a.float() - w).abs().max().item(), grad_max=w.abs().max().item(),
            rel_l2=chip_smoke.rel_l2(a, w))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = all(e["max_abs_err"] <= chip_smoke.TOL_BWD_MAX * e["grad_max"]
             and e["rel_l2"] <= chip_smoke.TOL_BWD_L2 for e in errors.values())
    chip_smoke.check(ok and same, f"{key} vs plain_bwd: {errors} (tol max "
                                  f"{chip_smoke.TOL_BWD_MAX} x max|grad|, rel L2 "
                                  f"{chip_smoke.TOL_BWD_L2}), bit-identical twice: {same}")
    q4, k4, v4 = (t.view(1, bh, n, d).detach().requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    do4 = do.view(1, bh, n, d)

    def library():
        return torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
    flops = BWD_PRODUCTS[name] * 2.0 * n * n * d * bh
    nbytes = (4 + len(BWD_OUTS[name])) * bh * n * d * 2 + 2 * bh * n * 4
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / chip_smoke.PEAK_BYTES * 1e3
    return dict(ms=chip_smoke.device_ms(lambda: fn(*args), 20, what=f"{key}"),
                plain_ms=chip_smoke.device_ms(lambda: FA.plain_bwd(*args), 3, 1,
                                              what=f"plain_bwd {key}"),
                library_ms=chip_smoke.device_ms(library, 20, what=f"SDPA backward {key}"),
                event_ms=chip_smoke.time_ms(lambda: fn(*args), 20),
                library_event_ms=chip_smoke.time_ms(library, 20),
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mb=nbytes / 1e6, errors=errors,
                max_abs_err=max(e["max_abs_err"] for e in errors.values()),
                max_err_share=max(e["max_abs_err"] / e["grad_max"] for e in errors.values()),
                same_twice=same)


def swin_shape(device, key, gen) -> dict:
    """``swin_pre`` at one shape key: held against ``plain_swin_pre`` (qkv
    and xr) with chip_smoke's Swin gates; device ms of the kernel, of the
    plain version and of ``F.linear`` on the already-normalised bf16 tokens,
    the kernel's CUDA-event ms, and the bound. The weight goes in the form
    the checkout's kernel reads: zero-padded (``swin_block.pad_weight``)
    where it has that, else the plain bf16 copy."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops._norms import ln_f32

    _, b, h, w, c, win, d = key
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = (randn(b, h * w, c, scale=2.0) + 0.5).to(bf16)
    ln_s, ln_b = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
    wq, bias = randn(3 * c, c, scale=c ** -0.5), randn(3 * c, scale=0.05)
    pad = getattr(SB, "pad_weight", None)
    wb = wq.to(bf16)
    wp = pad(wq) if pad is not None else wb

    def kern():
        return SB.swin_pre(x, ln_s, ln_b, wq, bias, h, w, win, d, w_packed=wp)

    got, want = kern(), SB.plain_swin_pre(x, ln_s, ln_b, wq, bias, h, w, win, d)
    again = kern()
    torch.cuda.synchronize()
    got, again, want = (torch.cat([t.flatten() for t in o]) for o in (got, again, want))
    err = (got.float() - want.float()).abs().max().item()
    o_max = want.float().abs().max().item()
    rel = chip_smoke.rel_l2(got, want)
    chip_smoke.check(err <= chip_smoke.TOL_SWIN_MAX * o_max and rel <= chip_smoke.TOL_SWIN_L2,
                     f"{key} vs plain: max abs {err}, rel L2 {rel}")
    xln = ln_f32(x, ln_s, ln_b).to(bf16)
    t_ops = 2.0 * b * h * w * c * 3 * c / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = ((5 * b * h * w * c + 3 * c * c) * 2 + 5 * c * 4) / chip_smoke.PEAK_BYTES * 1e3
    return dict(ms=chip_smoke.device_ms(kern, 20, what=f"{key}"),
                plain_ms=chip_smoke.device_ms(
                    lambda: SB.plain_swin_pre(x, ln_s, ln_b, wq, bias, h, w, win, d), 3, 1,
                    what=f"plain {key}"),
                library_ms=chip_smoke.device_ms(lambda: F.linear(xln, wb), 20,
                                                what=f"F.linear {key}"),
                event_ms=chip_smoke.time_ms(kern, 20), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_err_share=err / o_max, rel_l2=rel, same_twice=bool(torch.equal(got, again)))


def post_shape(device, key, gen) -> dict:
    """``swin_post`` at one shape key: held against ``plain_swin_post`` with
    chip_smoke's Swin gates, two calls bit-identical; device ms of the
    kernel, of the plain version and of ``F.linear`` alone for proj, fc1
    and fc2 on bf16 tokens, the kernel's CUDA-event ms, and the bound. The
    weights go in the form the checkout's kernel reads: zero-padded along K
    (``swin_block.pad_weight``) where it splits windows
    (``swin_block.post_split``), else plain bf16 copies."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import swin_block as SB

    _, b, h, w, c, win, hidden = key
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    nw, l = (h // win) * (w // win), h * w
    x = (randn(b, l, c, scale=2.0) + 0.5).to(bf16)
    attn = randn(b, nw, win * win, c).to(bf16)
    ws = [randn(c, c, scale=c ** -0.5), randn(c, scale=0.05), 1.0 + randn(c, scale=0.1),
          randn(c, scale=0.1), randn(hidden, c, scale=c ** -0.5), randn(hidden, scale=0.05),
          randn(c, hidden, scale=hidden ** -0.5), randn(c, scale=0.05)]
    wb = [ws[i].to(bf16) for i in (0, 4, 6)]
    packed = [SB.pad_weight(ws[i]) for i in (0, 4, 6)] if hasattr(SB, "post_split") else wb

    def kern():
        return SB.swin_post(attn, x, *ws, h, w, win, packed=packed)

    got, again = kern(), kern()
    want = SB.plain_swin_post(attn, x, *ws, h, w, win)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    o_max = want.float().abs().max().item()
    rel = chip_smoke.rel_l2(got, want)
    same = bool(torch.equal(got, again))
    chip_smoke.check(err <= chip_smoke.TOL_SWIN_MAX * o_max and rel <= chip_smoke.TOL_SWIN_L2
                     and same, f"{key} vs plain: max abs {err}, rel L2 {rel}, "
                               f"bit-identical twice: {same}")
    a2, hid = attn.reshape(b, l, c), randn(b, l, hidden).to(bf16)

    def lib():
        return F.linear(a2, wb[0]), F.linear(x, wb[1]), F.linear(hid, wb[2])
    flops = 2.0 * b * l * (c * c + 2 * c * hidden)
    nbytes = (3 * b * l * c + c * c + 2 * c * hidden) * 2 + (4 * c + hidden) * 4
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / chip_smoke.PEAK_BYTES * 1e3
    return dict(ms=chip_smoke.device_ms(kern, 20, what=f"{key}"),
                plain_ms=chip_smoke.device_ms(
                    lambda: SB.plain_swin_post(attn, x, *ws, h, w, win), 3, 1,
                    what=f"plain {key}"),
                library_ms=chip_smoke.device_ms(lib, 20, what=f"F.linear x3 {key}"),
                event_ms=chip_smoke.time_ms(kern, 20), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                split=SB.post_split(b, h, w, win, hidden) if hasattr(SB, "post_split") else None,
                max_err_share=err / o_max, rel_l2=rel, same_twice=same)


def win_shape(device, key, gen) -> dict:
    """K9 (``window_attention``) at one shape key through
    ``chip_smoke.swin_case``: packed q/k/v slices as swin_pre writes them,
    the restore's shift mask, held to chip_smoke's Swin gates, two calls
    bit-identical (at bs 2 also with a random mask of the same period);
    device ms of the kernel, of the plain version and of SDPA with the bias
    and mask as one additive mask, CUDA-event ms and the bound."""
    import chip_smoke

    r = chip_smoke.swin_case(device, key, gen)
    return dict(r, max_err_share=r["max_abs_err"] / r["out_max"])


def sweep(device, key, gen, label: str, mod, attr: str, choices, picked, measure) -> None:
    """``measure`` (:func:`flash_shape`, :func:`post_shape` or
    :func:`win_shape`) at ``key``
    with the rule ``mod.attr`` (a tile plan or a split rule) forced to each
    of ``choices`` in turn: device ms and the error of each, and which one
    the rule picks."""
    real = getattr(mod, attr)
    for choice in choices:
        setattr(mod, attr, lambda *a, _c=choice: _c)
        try:
            r = measure(device, key, gen)
        finally:
            setattr(mod, attr, real)
        print(f"{label}:", json.dumps(dict(key=list(key), choice=choice, picked=choice == picked,
                                          ms=r["ms"], max_err_share=r["max_err_share"])),
              flush=True)


def plan_sweep(device, key, gen) -> None:
    """The kernel of ``key`` at each (bm, bn, groups) the kernels take and
    shared memory holds (groups of 1 to 8 tiles a block): device ms, and
    the error against the plain version."""
    import torch

    import chip_smoke
    from edtr_torch.ops import _proj
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM

    name, b, n, c = key[:4]
    geglu = name in ("ln_geglu_proj", "geglu_proj")
    affine = name == "affine_matmul"
    x = (torch.randn((b, n, c), generator=gen, device=device) * 2 + 0.5).to(torch.bfloat16)
    s = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
    sh = 0.1 * torch.randn(c, generator=gen, device=device)
    if geglu:
        slab = 2 * key[4]
        w = torch.randn((slab, c), generator=gen, device=device) * c ** -0.5
        bias = 0.05 * torch.randn(slab, generator=gen, device=device)
        wp = w.to(torch.bfloat16)

        if name == "geglu_proj":
            def kern():
                return GG.geglu_proj(x, w, bias, w_packed=wp)
            want = GG.plain_geglu_proj(x, w, bias)
        else:
            def kern():
                return GG.ln_geglu_proj(x, s, sh, w, bias, w_packed=wp)
            want = GG.plain_ln_geglu_proj(x, s, sh, w, bias)
    elif affine:
        slab = key[4]
        w = torch.randn((slab, c), generator=gen, device=device) * c ** -0.5
        bias = 0.05 * torch.randn(slab, generator=gen, device=device)
        mul = 1 + 0.1 * torch.randn((b, c), generator=gen, device=device)
        add = 0.1 * torch.randn((b, c), generator=gen, device=device)
        wp = w.to(torch.bfloat16)

        def kern():
            return LM.affine_matmul(x, mul, add, w, bias, w_packed=wp)
        want = LM.plain_affine_matmul(x, mul, add, w, bias)
    else:
        o, k = key[4], key[5]
        slab = k * o
        ws = [torch.randn((o, c), generator=gen, device=device) * c ** -0.5 for _ in range(k)]
        wp = torch.cat([w.to(torch.bfloat16) for w in ws])

        def kern():
            return torch.cat(LM.ln_matmuls(x, s, sh, ws, w_packed=wp), -1)
        want = torch.cat(LM.plain_ln_matmuls(x, s, sh, ws), -1)
    m = b * n
    picked = _proj.lnproj_plan(m, c, slab, name)
    for bm in (64, 128) if name == "geglu_proj" else (32, 64):
        for bn in (128, 64) if geglu else ((160, 128, 64) if affine else (160, 64)):
            if m % bm or slab % bn or _proj.lnproj_stages(bn, c, max(bm, 64)) < 2:
                continue
            tiles = slab // bn
            for groups in sorted({-(-tiles // q) for q in range(1, min(tiles, 8) + 1)}):
                plan = (bm, bn, groups)
                real = (LM.lnproj_plan, GG.lnproj_plan)
                LM.lnproj_plan = GG.lnproj_plan = lambda *a, _p=plan: _p
                try:
                    got = kern()
                    torch.cuda.synchronize()
                    err = ((got.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                    ms = chip_smoke.device_ms(kern, 20, what=f"{key} plan {plan}")
                finally:
                    LM.lnproj_plan, GG.lnproj_plan = real
                print("proj plan:", json.dumps(dict(
                    key=list(key), plan=list(plan), picked=plan == picked,
                    blocks=(m // bm) * groups, tiles_per_block=-(-tiles // groups), ms=ms,
                    max_err_share=err)), flush=True)


def conv_shape(device, key, gen) -> dict:
    """A conv kernel at one shape ``key`` (``gn_conv.shapes``' key): held
    against its plain version with chip_smoke's gates, and device ms of the
    kernel, of the plain version and of ``F.conv2d`` on the activated (K5)
    or upsampled (K6) input; the bound (chip_smoke.conv_case's: K6 counts 4
    taps). K6's weights go in the form the checkout's kernel reads: folded
    (``fold_subpixel_weights``) where it has that, else 9-tap
    (``pack_weight``)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from edtr_torch.ops import gn_conv as GC

    name, b, cin, h, w, cout, has_emb, has_res, act = key
    up = name == "upsample_conv"
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    hin, win = (h // 2, w // 2) if up else (h, w)
    x = randn(b, cin, hin, win).to(bf16).contiguous(memory_format=torch.channels_last)
    w32 = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = randn(cout, scale=0.05)
    wb = w32.to(bf16).contiguous(memory_format=torch.channels_last)
    if up:
        fold = getattr(GC, "fold_subpixel_weights", None)
        wp = fold(w32, bf16) if fold is not None else GC.pack_weight(w32, bf16)
        lib_in = F.interpolate(x, scale_factor=2.0, mode="nearest")

        def kern():
            return GC.upsample_conv(x, w32, bias, act, w_packed=wp)

        def plain():
            return GC.plain_upsample_conv(x, w32, bias, act)
    else:
        wp = GC.pack_weight(w32, bf16)
        mul, add = 1 + randn(b, cin, scale=0.1), randn(b, cin, scale=0.1)
        emb = randn(b, cout, scale=0.5).to(bf16) if has_emb else None
        res = (randn(b, cout, h, w).to(bf16).contiguous(memory_format=torch.channels_last)
               if has_res else None)
        lib_in = F.silu((x.float() * mul[:, :, None, None] + add[:, :, None, None]).to(bf16))

        def kern():
            return GC.gn_silu_conv(x, mul, add, w32, bias, emb, res, w_packed=wp)

        def plain():
            return GC.plain_gn_silu_conv(x, mul, add, w32, bias, emb, res)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    o_max = want.float().abs().max().item()
    rel = chip_smoke.rel_l2(got, want)
    chip_smoke.check(err <= chip_smoke.TOL_CONV_MAX * o_max and rel <= chip_smoke.TOL_CONV_L2,
                     f"{key} vs plain: max abs {err}, rel L2 {rel}")
    flops = 2.0 * b * h * w * (4 if up else 9) * cin * cout
    t_ops = flops / chip_smoke.PEAK_BF16_FLOPS * 1e3
    t_bytes = ((b * hin * win * cin + b * h * w * cout * (2 if has_res else 1)
                + 9 * cin * cout) * 2 / chip_smoke.PEAK_BYTES * 1e3)
    iters = max(5, min(20, int(2e12 / flops)))
    return dict(ms=chip_smoke.device_ms(kern, iters, what=f"{key}"),
                plain_ms=chip_smoke.device_ms(plain, 3, 1, what=f"plain {key}"),
                library_ms=chip_smoke.device_ms(lambda: F.conv2d(lib_in, wb, None, 1, 1), iters,
                                                what=f"F.conv2d {key}"),
                event_ms=chip_smoke.time_ms(kern, iters), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_err_share=err / o_max, rel_l2=rel)


def gn_plan_sweep(device, key, gen) -> None:
    """K5 at ``key`` with each tile of ``gn_conv.GN_TILES`` its tier takes
    (8-row tiles for the whole-image tier, 16 rows for the band; the split
    rule of ``gn_conv.gn_split``): device ms and the error, as
    :func:`conv_shape` gives them."""
    from edtr_torch.ops import gn_conv as GC

    name, b, cin, h, w, cout = key[:6]
    real = GC.gn_plan
    picked = real(b, h, w, cin, cout, name)
    for (wn, th), bn in sorted(GC.GN_TILES.items()):
        if (th == 8) != (name == "gn_conv_whole") or cout % bn:
            continue
        plan = GC.gn_split(b, h, w, cin, cout, wn, th)
        GC.gn_plan = lambda *a, _p=plan: _p
        try:
            r = conv_shape(device, key, gen)
        finally:
            GC.gn_plan = real
        print("conv plan:", json.dumps(dict(key=list(key), plan=list(plan),
                                            picked=plan == picked, ms=r["ms"],
                                            max_err_share=r["max_err_share"])), flush=True)


def main() -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--conv", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--swin", action="store_true")
    ap.add_argument("--flash-bwd", action="store_true")
    args = ap.parse_args()
    proj = not (args.flash or args.swin or args.flash_bwd)
    if not torch.cuda.is_available():
        print("proj_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    from edtr_torch.ops import _cuda

    print("nvcc s:", _cuda.build_all(list(dict.fromkeys(
                                     ["ln_matmul", "geglu"] * proj
                                     + ["gn_conv"] * args.conv
                                     + ["flash_attention"] * args.flash
                                     + ["swin_block", "window_attention"] * args.swin
                                     + ["flash_attention", "flash_attention_bwd"]
                                     * args.flash_bwd))), flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(7)
    from edtr_torch.ops import flash_attention as FA
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops import window_attention as WA
    keys = ("ms", "event_ms", "library_ms", "plain_ms", "bound_ms")
    sums = {}
    for rnd in range(args.rounds):
        for key, count in sorted(RESTORE_SHAPES.items(), key=str) if proj else ():
            r = chip_smoke.proj_case(device, key, gen)
            line = dict(round=rnd, key=list(key), launches=count, tile=r.get("tile"),
                        max_err_share=r["max_abs_err"] / r["out_max"], rel_l2=r["rel_l2"],
                        bound_by=r["bound_by"], **{k: r[k] for k in keys})
            print("proj shape:", json.dumps(line), flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0:
                plan_sweep(device, key, gen)
        for key, (per, count) in sorted(GEGLU_SHAPES.items()) if proj else ():
            r = chip_smoke.proj_case(device, key, gen)
            print("proj shape:", json.dumps(dict(
                round=rnd, key=list(key), per=per, launches=count, tile=r.get("tile"),
                max_err_share=r["max_abs_err"] / r["out_max"], rel_l2=r["rel_l2"],
                bound_by=r["bound_by"], **{k: r[k] for k in keys})), flush=True)
            if args.plans and rnd == 0:
                plan_sweep(device, key, gen)
        conv = {**GN_SHAPES, **CONV_SHAPES} if args.conv else {}
        for key, count in sorted(conv.items(), key=str):
            r = conv_shape(device, key, gen)
            print("conv shape:", json.dumps(dict(round=rnd, key=list(key), launches=count, **r)),
                  flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0 and key[0] != "upsample_conv":
                gn_plan_sweep(device, key, gen)
        for key, (per, count) in sorted(FLASH_SHAPES.items()) if args.flash else ():
            r = flash_shape(device, key, gen)
            print("flash shape:", json.dumps(dict(round=rnd, key=list(key), per=per,
                                                  launches=count, **r)), flush=True)
            agg = sums.setdefault((rnd, f"{key[0]} per {per}"), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0 and key[0] == "streamkv_fwd" and hasattr(
                    FA, "streamkv_splits"):  # the KV split: whole or in two
                sweep(device, key, gen, "streamkv split", FA, "streamkv_splits", (1, 2),
                      FA.streamkv_splits(*key[1:]), flash_shape)
            elif args.plans and rnd == 0 and hasattr(FA, "FLASH_PLANS"):  # FLASH_PLANS' index
                sweep(device, key, gen, "flash plan", FA, "flash_plan",
                      range(len(FA.FLASH_PLANS)), FA.flash_plan(*key[1:]), flash_shape)
        for key, count in sorted(SWIN_SHAPES.items()) if args.swin else ():
            r = swin_shape(device, key, gen)
            print("swin shape:", json.dumps(dict(round=rnd, key=list(key), launches=count, **r)),
                  flush=True)
            agg = sums.setdefault((rnd, key[0]), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
        for key, (per, count) in sorted(POST_SHAPES.items()) if args.swin else ():
            r = post_shape(device, key, gen)
            print("swin shape:", json.dumps(dict(round=rnd, key=list(key), per=per,
                                                 launches=count, **r)), flush=True)
            agg = sums.setdefault((rnd, f"{key[0]} per {per}"), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0 and hasattr(SB, "post_split"):  # blocks a window
                b, h, w, _, win, hidden = key[1:]
                sweep(device, key, gen, "post split", SB, "post_split",
                      (1, 2) if hidden > SB.POST_SLAB else (1,),
                      SB.post_split(b, h, w, win, hidden), post_shape)
        for key, (per, count) in sorted(WIN_SHAPES.items()) if args.swin else ():
            r = win_shape(device, key, gen)
            print("swin shape:", json.dumps(dict(
                round=rnd, key=list(key), per=per, launches=count,
                split=WA.window_split(key[1], key[3]),
                max_err_share=r["max_err_share"], rel_l2=r["rel_l2"],
                same_twice=r["same_twice"], bound_by=r["bound_by"],
                **{k: r[k] for k in keys})), flush=True)
            agg = sums.setdefault((rnd, f"{key[0]} per {per}"), dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
            if args.plans and rnd == 0:  # blocks a window
                sweep(device, key, gen, "window split", WA, "window_split", (1, 2),
                      WA.window_split(key[1], key[3]), win_shape)
        for key, count in sorted(BWD_SHAPES.items()) if args.flash_bwd else ():
            r = bwd_shape(device, key, gen)
            print("bwd shape:", json.dumps(dict(round=rnd, key=list(key), launches=count, **r)),
                  flush=True)
            agg = sums.setdefault((rnd, f"{key[0]} per training step"),
                                  dict.fromkeys(keys, 0.0))
            for k in keys:
                agg[k] += count * r[k]
    for (rnd, name), agg in sorted(sums.items()):
        swin = name in ("swin_pre", "swin_post per restore", "window_attention per restore")
        scope = ("per fused+swin 512² restore" if swin else
                 name.split(" per ", 1)[1] if " per " in name else "per fused" + (
                     "" if name in CONV_NAMES else "+proj") + " 512² restore")
        print("proj summary:", json.dumps(dict(card=card, round=rnd, kernel=name.split()[0],
                                               scope=scope, **agg)), flush=True)
    # device_ms's traces taken again and calls timed by CUDA events
    print("device_ms traces:", json.dumps(chip_smoke.TRACE_STATS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
