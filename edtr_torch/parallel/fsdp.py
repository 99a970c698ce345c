"""FSDP (ZeRO-3) sharding of parameters and optimiser state over ``data``.

Counterpart of ``edtr_tpu/parallel/fsdp.py``. :func:`fsdp_spec` puts
``data`` on the largest dim of a parameter of 16 KiB and up that the
``data`` dim divides and tensor parallelism leaves free (``tp_spec``, the
two composed as JAX's 2-D layout). The dims are the torch layout's, taken
in JAX's order (:func:`jax_layout`: Linear (out, in) is JAX's (in, out),
OIHW is HWIO, a transposed conv's (in, out, kh, kw) is (kh, kw, in, out)),
so ties break as JAX's do and :func:`fsdp_param_bytes` equals JAX's.

:func:`shard_params_fsdp` is ``fully_shard`` over the ``data`` dim with
those dims (``shard_placement_fn``): FSDP gathers each parameter before
its module runs and reduce-scatters the gradient after, so the parameters,
their gradients and the optimiser's moments (AdamW's ``exp_avg`` and
``exp_avg_sq`` are DTensors of the same placement) are 1/n_data a rank.
The parameters below ``min_bytes`` or with no such dim stay whole on every
rank, outside FSDP (``ignored_params``): their gradients are averaged by
``edtr_torch.parallel.distributed.average_gradients``, as every other
data-parallel gradient. FSDP runs over a ``(n_data, 1)`` mesh here; the
specs and byte counts compose with tensor parallelism as JAX's do.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Placement, Replicate, Shard

from edtr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from edtr_torch.parallel.tp import _divisible, dim_size, tp_spec

__all__ = ["fsdp_spec", "fsdp_shardings", "shard_params_fsdp", "fsdp_param_bytes",
           "jax_layout"]

# below this, replication costs less than the per-step gather (JAX's)
DEFAULT_MIN_BYTES = 1 << 14


def jax_layout(module: nn.Module, name: str) -> Tuple[int, ...]:
    """``perm`` with JAX's shape of parameter ``name`` = the torch shape's
    dims ``perm``: a Linear's (or a fused attention projection's) weight
    transposed, a conv's OIHW as HWIO, a transposed conv's IOHW as HWIO;
    every other parameter as it is."""
    from edtr_torch.models.layers import Linear

    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    p = getattr(owner, leaf)
    if p.ndim == 2 and (isinstance(owner, (Linear, nn.Linear)) or leaf == "in_proj_weight"):
        return (1, 0)
    if p.ndim == 4:
        return (2, 3, 0, 1) if type(owner).__name__.startswith("ConvTranspose") else (2, 3, 1, 0)
    return tuple(range(p.ndim))


def fsdp_spec(name: str, shape: Sequence[int], n_data: int, n_model: int = 1,
              min_bytes: int = DEFAULT_MIN_BYTES, itemsize: int = 4,
              perm: Optional[Sequence[int]] = None) -> List[Placement]:
    """The (data, model) placements of one parameter: its :func:`tp_spec`
    on ``model`` (replicated where ``n_model`` does not divide it), and
    ``Shard(d)`` on ``data`` for the largest free dim ``n_data`` divides,
    the dims taken in JAX's order ``perm`` (:func:`jax_layout`) largest
    first; a leaf under ``min_bytes`` keeps the model placement alone."""
    shape = tuple(shape)
    perm = tuple(range(len(shape))) if perm is None else tuple(perm)
    base = tp_spec(name, shape)
    if not _divisible(base, shape, n_model):
        base = Replicate()
    if math.prod(shape or (1,)) * itemsize < min_bytes:
        return [Replicate(), base]
    taken = base.dim if isinstance(base, Shard) else None
    for i in sorted(range(len(shape)), key=lambda i: -shape[perm[i]]):
        d = perm[i]
        if d != taken and shape[d] % n_data == 0 and shape[d] >= n_data:
            return [Shard(d), base]
    return [Replicate(), base]


def fsdp_shardings(module: nn.Module, mesh,
                   min_bytes: int = DEFAULT_MIN_BYTES) -> Dict[str, List[Placement]]:
    """Each parameter's (data, model) placements under FSDP composed with
    the TP plan (``mesh``: a DeviceMesh or its sizes, ``tp.dim_size``)."""
    n_data, n_model = dim_size(mesh, DATA_AXIS), dim_size(mesh, MODEL_AXIS)
    return {name: fsdp_spec(name, tuple(p.shape), n_data, n_model, min_bytes,
                            p.element_size(), jax_layout(module, name))
            for name, p in module.named_parameters()}


def fsdp_param_bytes(module: nn.Module, mesh,
                     min_bytes: int = DEFAULT_MIN_BYTES) -> Tuple[int, int]:
    """(bytes a device holds, total bytes) under FSDP and the TP plan, JAX's
    ``fsdp_param_bytes``."""
    n_data, n_model = dim_size(mesh, DATA_AXIS), dim_size(mesh, MODEL_AXIS)
    per_dev = total = 0
    for name, (data, model) in fsdp_shardings(module, mesh, min_bytes).items():
        p = module.get_parameter(name)
        nbytes = p.numel() * p.element_size()
        total += nbytes
        div = (n_data if isinstance(data, Shard) else 1) * (
            n_model if isinstance(model, Shard) else 1)
        per_dev += nbytes // div
    return per_dev, total


def shard_params_fsdp(module: nn.Module, mesh: DeviceMesh,
                      min_bytes: int = DEFAULT_MIN_BYTES) -> nn.Module:
    """``fully_shard`` of ``module`` over the ``data`` dim of ``mesh`` (a
    mesh whose ``model`` dim is 1), each sharded parameter on its
    :func:`fsdp_spec` dim, the rest left whole (module docstring)."""
    n_data, n_model = dim_size(mesh, DATA_AXIS), dim_size(mesh, MODEL_AXIS)
    if n_model != 1:
        raise ValueError("FSDP runs over an (n_data, 1) mesh")
    dims = {}
    ignored = set()
    for name, (data, _) in fsdp_shardings(module, mesh, min_bytes).items():
        p = module.get_parameter(name)
        if isinstance(data, Shard):
            dims[p] = data
        else:
            ignored.add(p)
    data_mesh = mesh[DATA_AXIS] if mesh.ndim > 1 else mesh
    fully_shard(module, mesh=data_mesh, shard_placement_fn=dims.get, ignored_params=ignored)
    return module
