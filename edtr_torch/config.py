"""Config system of the port: the repo's YAML configs and their
``target:``/``params:`` nodes.

Counterpart of ``edtr_tpu/config.py``: :class:`Config` (attribute access
over a nested dict), :func:`load_config` (``yaml.safe_load``),
:func:`get_obj_from_str` and :func:`instantiate_from_config`. The configs
name the reference's targets (``model.resnet.ResNet``, ...); :data:`REGISTRY`
maps each to the port's constructor, and ``edtr_torch.*`` paths resolve by
import. A reference target the port does not have yet (the datasets, the
ResNet50-FPN-v2 detector, the unused restoration nets, the dead
``nsampler`` encoder) raises :class:`NotPortedError` naming it; any other
path outside ``edtr_torch`` raises too, so nothing resolves into the JAX
package.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Iterator, Optional

import yaml


class Config:
    """Attribute-access view over a nested dict (OmegaConf-lite)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return [_wrap(v) for v in self._data.values()]

    def items(self):
        return [(k, _wrap(v)) for k, v in self._data.items()]

    def get(self, key: str, default: Any = None) -> Any:
        return _wrap(self._data[key]) if key in self._data else default

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return _wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _wrap(v: Any) -> Any:
    return Config(v) if isinstance(v, dict) else v


def _unwrap(v: Any) -> Any:
    return v.to_dict() if isinstance(v, Config) else v


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return Config(yaml.safe_load(f))


class NotPortedError(NotImplementedError):
    """A config target with no counterpart in the port yet."""


# reference target -> the port's constructor (None: not ported yet)
REGISTRY: Dict[str, Optional[str]] = {
    "model.cldm.ControlLDM": "edtr_torch.models.cldm.ControlLDM",
    "model.gaussian_diffusion.Diffusion": "edtr_torch.diffusion.schedule.create_diffusion",
    "model.swinir.SwinIR": "edtr_torch.models.swinir.SwinIR",
    "model.resnet.ResNet": "edtr_torch.models.resnet.resnet",
    "model.faster_rcnn.fasterrcnn_mobilenet_v3_large_fpn":
        "edtr_torch.models.faster_rcnn.fasterrcnn_mobilenet_v3_large_fpn",
    "model.deeplabv3.deeplabv3_mobilenet_v3_large":
        "edtr_torch.models.deeplabv3.deeplabv3_mobilenet_v3_large",
    "model.deeplabv3.deeplabv3_resnet50": "edtr_torch.models.deeplabv3.deeplabv3_resnet50",
    "model.faster_rcnn.fasterrcnn_resnet50_fpn_v2": None,
    "model.vae.Encoder": None,
    "model.bsrnet.RRDBNet": None,
    "model.scunet.SCUNet": None,
    "model.skunet.SKUNet": None,
    "model.edsr.EDSR": None,
    "datasets.classification.DegradedClassificationDataset": None,
    "datasets.classification.PairedClassificationDataset": None,
    "datasets.segmentation.DegradedSegmentationDataset": None,
    "datasets.segmentation.PairedSegmentationDataset": None,
    "datasets.detection.DegradedDetectionDataset": None,
    "datasets.detection.PairedDetectionDataset": None,
    "datasets.detection.RealworldDetectionDataset": None,
    "datasets.detection_coco.DegradedDetectionDatasetCoco": None,
    "datasets.detection_coco.PairedDetectionDatasetCoco": None,
    "datasets.detection_cocov2.DegradedDetectionDatasetCocov2": None,
    "datasets.detection_cocov2.RealESRGANBatchTransform": None,
    "datasets.file_backend.HardDiskBackend": None,
}


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """The object a target names: a reference target through
    :data:`REGISTRY`, or an ``edtr_torch.*`` dotted path."""
    if string in REGISTRY:
        if REGISTRY[string] is None:
            raise NotPortedError(f"config target {string!r} is not yet ported to edtr_torch")
        string = REGISTRY[string]
    elif not string.startswith("edtr_torch."):
        raise NotPortedError(f"config target {string!r} names nothing in edtr_torch")
    module, name = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, name)


def instantiate_from_config(config: Any, **extra_kwargs: Any) -> Any:
    """The object ``config.target`` names, built with ``config.params``
    updated by ``extra_kwargs`` (e.g. ``dtype=``, ``device=``)."""
    if isinstance(config, Config):
        config = config.to_dict()
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params", {}) or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)
