"""Host side shared by the transformer-projection kernels
(``ops/ln_matmul.py``, ``ops/geglu.py``; all on ``csrc/proj_wgmma.cuh``):
the tile plans, the shared-memory rule of the predicates, the operand
checks, the launch's error check, and the fp32-accumulated product of the
plain versions."""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

C_MULT = 32  # C a multiple of this: TMA zero-fills the half chunk past it
SMS = 132  # streaming multiprocessors of an H100 SXM
# proj_wgmma.cuh: channels per chunk (a 128-byte swizzle row), the shared
# memory a block may use, and the deepest weight ring
KC = 64
SMEM_LIMIT = 232448
MAX_STAGES = 4


def dot32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of ``a`` and ``w`` rounded to ``a``'s dtype, accumulated
    and returned in fp32 (``jnp.dot(..., preferred_element_type=f32)``).
    ``w`` is in nn.Linear layout (out, in)."""
    return F.linear(a.float(), w.to(a.dtype).float())


def lnproj_smem(bn: int, c: int, stages: int, rows: int = 64) -> int:
    """Dynamic shared memory of a ``proj_wgmma.cuh`` block
    (``smem_bytes``): the alignment slack, the resident (``rows``, C)
    tokens (64 for blocks of 32 or 64 rows, 128 for K7a's 128-row blocks),
    the ring, the output staging and the barriers."""
    return (1024 + -(-c // KC) * rows * 2 * KC + stages * bn * 2 * KC + 8 * 512
            + (2 * MAX_STAGES + 2 + 32) * 8)


def lnproj_stages(bn: int, c: int, rows: int = 64) -> int:
    """Weight-ring stages of a ``proj_wgmma.cuh`` block (``launch``): as
    many as shared memory holds beside the resident (``rows``, C) tokens and
    the output staging, at most :data:`MAX_STAGES`."""
    return min(MAX_STAGES, (SMEM_LIMIT - lnproj_smem(bn, c, 0, rows)) // (bn * 2 * KC))


def lnproj_fits(c: int) -> bool:
    """Whether a block's resident (64, C) tokens leave room for a 2-stage
    ring of 64-row weight tiles: the widest C any ``proj_wgmma.cuh`` plan
    takes (1600), a condition of every projection kernel's predicate."""
    return c > 0 and lnproj_stages(64, c) >= 2


@functools.lru_cache(maxsize=None)
def lnproj_plan(m: int, c: int, slab_rows: int, kind: str) -> Tuple[int, int, int]:
    """``(bm, bn, groups)`` of a ``proj_wgmma.cuh`` launch of wrapper
    ``kind`` ("ln_matmuls", "ln_geglu_proj", "affine_matmul" or
    "geglu_proj") over ``m``
    token rows of ``c`` channels and ``slab_rows`` weight rows; as many
    column groups as one wave of blocks takes (one an SM: a block holds most
    of its shared memory). Raises ValueError for a C whose tokens do not
    fit beside a 2-stage ring.

    The LayerNorm forms: 160-row weight tiles for K8a (they divide every
    main-path slab, 320-3840) and 128-row ones for GEGLU (64 h + 64 gate
    rows), else 64; and 64-row blocks, unless those would leave half the SMs
    idle: then 32-row ones, which halve the LayerNorm each block does first.

    The affine form (K8b) has no statistics to share out, and a block's
    fixed cost (its tokens by TMA and the affine before the first product)
    is best paid once a tile: one weight tile a block, the (bm, bn) with the
    most blocks within one wave, then the wider tile: 64 x 160 at 4096
    tokens, 32 x 160 at 1024 and 32 x 128 at 256 (a sweep of every plan on
    the card, PERF.md).

    K7a (``geglu_proj``) has no prologue: 128-token blocks where M allows
    and its (128, C) tokens fit beside a 2-stage ring (every block then
    streams the weight once for twice the rows), else 64; 128-row weight
    tiles (64 h + 64 gate rows) where ``inner`` % 64 == 0, else 64; as many
    column groups as one wave takes."""
    if kind == "affine_matmul":
        best = None
        for bm in (64, 32):
            for bn in (160, 128, 64):
                if m % bm or slab_rows % bn or lnproj_stages(bn, c) < 2:
                    continue
                blocks = (m // bm) * (slab_rows // bn)
                score = (blocks <= SMS, blocks if blocks <= SMS else -blocks, bn)
                if best is None or score > best[0]:
                    best = (score, (bm, bn, slab_rows // bn))
        if best is None:
            raise ValueError(f"{c} channels do not fit the affine kernel's shared memory")
        return best[1]
    if kind == "geglu_proj":
        bn = 128 if slab_rows % 128 == 0 else 64
        bm = 128 if m % 128 == 0 and lnproj_stages(bn, c, 128) >= 2 else 64
        if lnproj_stages(bn, c, bm) < 2:
            bn = 64
        if lnproj_stages(bn, c, bm) < 2:
            raise ValueError(f"{c} channels do not fit the GEGLU kernel's shared memory")
        tiles = slab_rows // bn
        return bm, bn, min(tiles, max(1, SMS // (m // bm)))
    geglu = kind == "ln_geglu_proj"
    bn = (128 if slab_rows % 128 == 0 else 64) if geglu else (160 if slab_rows % 160 == 0
                                                               else 64)
    if lnproj_stages(bn, c) < 2:
        bn = 64
    if lnproj_stages(bn, c) < 2:
        raise ValueError(f"{c} channels do not fit the LayerNorm kernels' shared memory")
    tiles = slab_rows // bn

    def groups(bm: int) -> int:
        return min(tiles, max(1, SMS // (m // bm)))
    bm = 64 if m % 64 == 0 and (m // 64) * groups(64) >= SMS // 2 else 32
    return bm, bn, groups(bm)


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{what} must be {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} data is not 16-byte aligned")


def check_tokens(name: str, x: torch.Tensor, seq_ok: bool) -> None:
    """The kernels' token operand: (B, N, C) bf16, contiguous (unit stride
    along C), N a size the TPU kernel takes, C a multiple of 32."""
    if x.dtype != torch.bfloat16 or x.ndim != 3:
        raise ValueError(f"{name}: x must be (B, N, C) bf16, got {x.dtype} {tuple(x.shape)}")
    if not seq_ok:
        raise ValueError(f"{name}: {x.shape[1]} tokens is not a size the kernel takes")
    if x.shape[2] % C_MULT or x.shape[2] == 0:
        raise ValueError(f"{name}: C must be a multiple of {C_MULT}, got {x.shape[2]}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")


def raise_on_error(name: str, err: int) -> None:
    """The C interface returns ``cudaGetLastError()``: raise unless 0."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def on_device(dev: torch.device):
    """The launch goes to the current device: make ``dev`` current for it."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
