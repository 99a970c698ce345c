"""Checkpoints of the port: the reference's per-submodule state dicts, the
full train state, SD2.1 and ControlNet loading, and the demo's combined
file.

Counterpart of ``edtr_tpu/utils/checkpoint.py``; the loading that
``edtr_tpu/models/cldm.py`` (``load_pretrained_sd``,
``load_controlnet_from_unet``) and ``edtr_tpu/utils/convert.py``
(``split_sd_checkpoint``, ``controlnet_from_unet``) do for the runner.

* :func:`save_submodules` writes ``{name}_{step}.pt`` and ``{name}_last.pt``,
  each a ``torch.save`` of the module's state dict under the reference's
  keys, the files the configs' ``resume_*: .../swinir_last.pt`` name (JAX
  writes orbax directories, a TPU choice).
* :func:`save_checkpoint` / :func:`restore_checkpoint` hold the whole
  train state (every module's parameters and buffers, each optimizer's and
  schedule's ``state_dict``, the step) in one file, written to a temporary
  name and renamed, so an interrupted save leaves the last good file.
* :func:`load_torch_state_dict` and :func:`load_network` read a reference
  state dict (``weights_only=True``) and report the key diff in JAX's words.
* :func:`load_pretrained_sd` loads an SD2.1 checkpoint's UNet, VAE and CLIP
  text tower (``model.diffusion_model.*``, ``first_stage_model.*``,
  ``cond_stage_model.model.*``; the tower's blocks up to the penultimate
  layer); :func:`controlnet_from_unet` initialises the ControlNet from the
  UNet as the reference does.
* :func:`load_combined`: the demo's single file ``{swinir, cldm, decoder,
  detnet}``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

PARTS = ("swinir", "cldm", "decoder", "detnet")
# an SD2.1 checkpoint's prefix of each ControlLDM part (JAX's SD_MODULE_MAP;
# OpenCLIP's text keys sit under ``model.`` of the embedder)
SD_MODULE_MAP = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                 "clip": "cond_stage_model.model."}
# the ControlNet parts copied from the UNet; zero_convs and middle_block_out
# start at zero
_FROM_UNET = ("input_blocks.", "middle_block.", "time_embed.")
_ZERO = ("zero_convs.", "middle_block_out.")


def _no_tracking(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # BatchNorm's num_batches_tracked carries no numerics and the port's
    # norms keep none
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _strict(module: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    missing, unexpected = module.load_state_dict(_no_tracking(sd), strict=False)
    if missing or unexpected:
        raise ValueError(f"checkpoint part {what!r}: {len(missing)} missing keys (e.g. "
                         f"{sorted(missing)[:3]}), {len(unexpected)} unexpected (e.g. "
                         f"{sorted(unexpected)[:3]})")


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _host(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_submodules(ckpt_dir: str, modules: Mapping[str, Any],
                    step: Optional[int] = None) -> Tuple[str, ...]:
    """For each ``name: module`` (or its state dict), ``{name}_{step}.pt``
    (when ``step`` is given) and ``{name}_last.pt`` in ``ckpt_dir``: the
    state dict under the reference's keys, on the host. Returns the paths
    written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    paths = []
    for name, module in modules.items():
        sd = _host(module.state_dict() if isinstance(module, nn.Module) else module)
        for tag in ((step, "last") if step is not None else ("last",)):
            path = os.path.join(ckpt_dir, f"{name}_{tag}.pt")
            _atomic_save(sd, path)
            paths.append(path)
    return tuple(paths)


def _stateful(state) -> Dict[str, Any]:
    """The fields of a train state (a dataclass: ``EDTRTrainState``,
    ``SimpleTrainState``) that carry a ``state_dict``: modules, optimizers,
    schedules."""
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return {k: v for k, v in fields.items() if hasattr(v, "state_dict")}


def save_checkpoint(path: str, state) -> None:
    """The whole train ``state`` in one file at ``path``: each module's,
    optimizer's and schedule's ``state_dict`` under its field's name and
    ``step``; written to ``path + ".tmp"`` and renamed over ``path``."""
    obj = {name: part.state_dict() for name, part in _stateful(state).items()}
    obj["step"] = int(state.step)
    _atomic_save(obj, path)


def restore_checkpoint(path: str, state) -> None:
    """Load :func:`save_checkpoint`'s file into ``state`` in place (modules
    strictly, optimizers and schedules by their ``load_state_dict``, the
    step); a field the file lacks raises ``KeyError``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for name, part in _stateful(state).items():
        if name not in obj:
            raise KeyError(f"train state {path!r} holds no {name!r}")
        if isinstance(part, nn.Module):
            part.load_state_dict(obj[name], strict=True)
        else:
            part.load_state_dict(obj[name])
    state.step = int(obj["step"])


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict (``torch.load(weights_only=True)``
    on the host): a ``state_dict`` entry unwrapped, ``module.`` stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}


def _report_key_diff(expected: Iterable[str], loaded: Iterable[str], strict: bool) -> None:
    """JAX's ``_report_key_diff``: raises ``ValueError`` (``strict``) or
    prints the missing and unexpected keys."""
    expected, loaded = set(expected), set(loaded)
    missing, unexpected = expected - loaded, loaded - expected
    if missing or unexpected:
        msg = (f"checkpoint key diff: {len(missing)} missing "
               f"(e.g. {sorted(missing)[:3]}), {len(unexpected)} unexpected "
               f"(e.g. {sorted(unexpected)[:3]})")
        if strict:
            raise ValueError(msg)
        print(f"[load_network] {msg}")


def load_network(path: str, module: nn.Module, strict: bool = True) -> nn.Module:
    """Load the state dict file at ``path`` into ``module`` (in place, onto
    its device and dtypes) and return it; the key diff is reported as JAX's
    ``load_network`` words it and raises when ``strict``. A directory (an
    orbax tree of JAX's runner) raises: it cannot be read without JAX."""
    if os.path.isdir(path):
        raise IsADirectoryError(f"{path!r} is a directory (an orbax checkpoint of the JAX "
                                "package); the port reads torch state dict files")
    sd = _no_tracking(load_torch_state_dict(path))
    _report_key_diff(module.state_dict().keys(), sd.keys(), strict)
    module.load_state_dict(sd, strict=False)
    return module


def load_pretrained_sd(cldm: nn.Module, sd: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """JAX's ``ControlLDM.load_pretrained_sd`` (``split_sd_checkpoint`` over
    :data:`SD_MODULE_MAP`): every key of ``cldm.unet``, ``cldm.vae`` and
    ``cldm.clip`` read from the SD2.1 state dict ``sd`` under its prefix (a
    missing one raises ``KeyError``); the tower's blocks past the
    penultimate layer, the text projection and the rest of ``sd`` are left.
    Returns the keys of ``sd`` left unused."""
    used = set()
    for part, prefix in SD_MODULE_MAP.items():
        module = getattr(cldm, part)
        want = module.state_dict()
        missing = [k for k in want if prefix + k not in sd]
        if missing:
            raise KeyError(f"SD checkpoint lacks {len(missing)} keys of {part} "
                           f"(e.g. {[prefix + k for k in missing[:3]]})")
        module.load_state_dict({k: sd[prefix + k] for k in want}, strict=True)
        used.update(prefix + k for k in want)
    return tuple(sorted(set(sd) - used))


@torch.no_grad()
def controlnet_from_unet(unet: nn.Module, controlnet: nn.Module) -> None:
    """JAX's ``controlnet_from_unet`` (the reference's
    ``load_controlnet_from_unet``), in place: the ControlNet's
    ``input_blocks``, ``middle_block`` and ``time_embed`` copied from the
    UNet, the first conv's input channels zero-padded for the hint, every
    zero conv and ``middle_block_out`` zero. A ControlNet key of no such
    part raises ``KeyError``."""
    src = unet.state_dict()
    out = {}
    for key, value in controlnet.state_dict().items():
        if key.startswith(_ZERO):
            out[key] = torch.zeros_like(value)
        elif key.startswith(_FROM_UNET):
            w = src[key]
            if w.shape != value.shape:  # the first conv: x's channels, then the hint's
                pad = value.shape[1] - w.shape[1]
                w = torch.cat([w, w.new_zeros((w.shape[0], pad) + tuple(w.shape[2:]))], 1)
            out[key] = w
        else:
            raise KeyError(f"ControlNet key {key!r} has no UNet counterpart")
    controlnet.load_state_dict(out, strict=True)


def load_combined(path: str, pipe: nn.Module, detnet: Optional[nn.Module] = None) -> tuple:
    """Load the parts of the combined checkpoint at ``path``
    (``torch.load(weights_only=True)``) into ``pipe`` (``swinir``,
    ``cldm``, then ``decoder`` over the VAE's decoder) and ``detnet``; raises
    ``ValueError`` on a part it does not know, on a part with nowhere to go,
    and on any missing or unexpected key. Returns the parts loaded."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    unknown = sorted(set(obj) - set(PARTS))
    if unknown:
        raise ValueError(f"combined checkpoint: unknown parts {unknown}, expected {PARTS}")
    targets = dict(swinir=pipe.swinir, cldm=pipe.cldm, decoder=pipe.cldm.vae.decoder,
                   detnet=detnet)
    loaded = []
    for part in PARTS:
        if part not in obj:
            continue
        if targets[part] is None:
            raise ValueError(f"combined checkpoint: part {part!r} has no module to load into")
        _strict(targets[part], obj[part], part)
        loaded.append(part)
    return tuple(loaded)
