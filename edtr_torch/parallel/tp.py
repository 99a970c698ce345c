"""Tensor parallelism over the mesh's ``model`` dim.

Counterpart of ``edtr_tpu/parallel/tp.py``: JAX's Megatron plan on the
port's parameter names (the reference checkpoint keys, which
``edtr_torch/utils/convert.py`` relates to JAX's paths) and torch layouts
(Linear (out, in), conv OIHW):

- column split (``Shard(0)``): ``to_q``/``to_k``/``to_v``,
  ``ff.net.0.proj`` (the GEGLU projection), ``emb_layers.1`` and
  ``in_layers.2``;
- row split (``Shard(1)``): ``to_out.0``, ``ff.net.2`` and
  ``out_layers.3`` (and the UNet's last conv ``out.2``, which JAX's
  ``out_conv`` pattern also takes);
- every other parameter replicated, and a leaf whose split dim the
  ``model`` dim does not divide too.

JAX writes placements and lets GSPMD keep the semantics; here
:func:`shard_params` stores each split parameter as a DTensor on the
``model`` dim (JAX's placement, so :func:`tp_param_bytes` equals JAX's) and
the modules compute on local tensors:

- attention whose heads the ``model`` dim divides splits its compute:
  each rank projects q/k/v by its rows, attends over its heads, projects
  out by its columns, and the ranks' partial outputs are summed
  (:func:`to_model_region` / :func:`from_model_region`, Megatron's
  identity-forward / all-reduce-backward pair and its converse);
- every other split weight (the GEGLU projection, whose output is
  ``[x, gate]``, so a plain column split would hand one rank all of
  ``x``; attention with heads the dim does not divide, such as 5 heads of
  64 over 2; the ResBlock convs around a GroupNorm) is gathered before
  it is used (``models.layers.whole``), its compute replicated.

The kernels stay on, where JAX runs TP with its Pallas kernels off (GSPMD
cannot partition a whole-array kernel): every kernel here reads local
tensors, a gathered weight (its packed form made per call) or this rank's
heads. Tensor parallelism runs over a ``(1, n_model)`` mesh: with data
parallelism beside it, the split parameters' gradients would also need
their data-dim average, which :func:`~edtr_torch.parallel.distributed.average_gradients`
does not do.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

from edtr_torch.parallel.mesh import MODEL_AXIS, is_sharded

__all__ = ["tp_spec", "tp_shardings", "shard_params", "tp_param_bytes",
           "to_model_region", "from_model_region"]

_COLUMN = re.compile(r"(to_q|to_k|to_v)\.weight$|ff\.net\.0\.proj\.weight$|emb_layers\.1\.weight$")
_ROW = re.compile(r"to_out\.0\.weight$|ff\.net\.2\.weight$")
_CONV_COLUMN = re.compile(r"in_layers\.2\.weight$")
_CONV_ROW = re.compile(r"out_layers\.3\.weight$|(^|\.)out\.2\.weight$")


def tp_spec(name: str, shape: Tuple[int, ...]) -> Placement:
    """The ``model``-dim placement of one parameter under the plan:
    ``Shard(0)`` (column), ``Shard(1)`` (row) or ``Replicate()``, before
    the divisibility check of :func:`tp_shardings`."""
    if len(shape) == 2 and _COLUMN.search(name):
        return Shard(0)
    if len(shape) == 2 and _ROW.search(name):
        return Shard(1)
    if len(shape) == 4 and _CONV_COLUMN.search(name):
        return Shard(0)
    if len(shape) == 4 and _CONV_ROW.search(name):
        return Shard(1)
    return Replicate()


def _divisible(spec: Placement, shape: Tuple[int, ...], n_model: int) -> bool:
    return not isinstance(spec, Shard) or shape[spec.dim] % n_model == 0


def dim_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name`` (1 where it has none); ``mesh``
    a DeviceMesh or its sizes by name, as JAX's ``mesh.shape`` gives them
    (the plan and the byte counts need no process group)."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(name, 1))
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def tp_shardings(module: nn.Module, mesh) -> Dict[str, Placement]:
    """Each parameter's ``model``-dim placement: :func:`tp_spec`, and
    ``Replicate()`` where the ``model`` dim does not divide the split
    dim."""
    n = dim_size(mesh, MODEL_AXIS)
    out = {}
    for name, p in module.named_parameters():
        spec = tp_spec(name, tuple(p.shape))
        out[name] = spec if _divisible(spec, tuple(p.shape), n) else Replicate()
    return out


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Every split parameter of ``module`` replaced, in place, by a DTensor
    parameter on the ``model`` dim of ``mesh`` (each rank keeps its
    shard); the rest stay local tensors. ``mesh`` must have a ``data`` dim
    of 1 (module docstring)."""
    if mesh.size() != dim_size(mesh, MODEL_AXIS):
        raise ValueError("tensor parallelism runs over a (1, n_model) mesh")
    sub = mesh[MODEL_AXIS] if mesh.ndim > 1 else mesh
    for name, spec in tp_shardings(module, mesh).items():
        if isinstance(spec, Shard):
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            p = getattr(owner, leaf)
            owner.register_parameter(leaf, nn.Parameter(
                distribute_tensor(p.detach(), sub, [spec]), requires_grad=p.requires_grad))
    return module


def tp_param_bytes(module: nn.Module, mesh) -> Tuple[int, int]:
    """(bytes a device holds, total bytes) of ``module``'s parameters under
    the plan, JAX's ``tp_param_bytes`` (a split leaf's bytes over the
    ``model`` dim, floored)."""
    n = dim_size(mesh, MODEL_AXIS)
    per_dev = total = 0
    for name, spec in tp_shardings(module, mesh).items():
        p = module.get_parameter(name)
        nbytes = p.numel() * p.element_size()
        total += nbytes
        per_dev += nbytes // n if isinstance(spec, Shard) else nbytes
    return per_dev, total


class _ToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model_region(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``group``: the input of a
    column-split projection, whose ranks each give part of it."""
    return _ToModelRegion.apply(x, group)


def from_model_region(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial outputs of a row-split projection,
    the gradient passed on as it is."""
    return _FromModelRegion.apply(x, group)


def split_attention_heads(module_heads: int, weights: List[torch.Tensor]) -> int:
    """The heads each rank computes when the q/k/v and output weights are
    split over a ``model`` dim that divides ``module_heads`` (0: not
    split, or not divisible: gather)."""
    if not all(is_sharded(w) for w in weights):
        return 0
    n = weights[0].device_mesh.size()
    return module_heads // n if module_heads % n == 0 else 0
