"""The real-world demo's combined checkpoint.

Counterpart of ``edtr_tpu/utils/checkpoint.py:load_combined``: one file
holding ``{swinir, cldm, decoder, detnet}``, each the reference model's
state dict (the SwinIR's, the ControlLDM's ``unet.*`` / ``controlnet.*`` /
``vae.*`` / ``clip.*``, the trained VAE decoder's, the detector's
torchvision keys). The port's modules carry those names, so each part
loads strictly into its module; a part the file lacks is left as it is.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

PARTS = ("swinir", "cldm", "decoder", "detnet")


def _strict(module: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> None:
    # BatchNorm's num_batches_tracked carries no numerics and the port's
    # norms keep none; every other missing or unexpected key raises
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise ValueError(f"checkpoint part {what!r}: {len(missing)} missing keys (e.g. "
                         f"{sorted(missing)[:3]}), {len(unexpected)} unexpected (e.g. "
                         f"{sorted(unexpected)[:3]})")


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
