"""Logging and the experiment environment of the port's runner.

Counterpart of ``edtr_tpu/utils/logging_utils.py``:

* :class:`Logger`: console INFO and ``run.log`` DEBUG on rank 0 only
  (``torch.distributed``'s rank when a process group is up, else 0);
* :class:`ScalarWriter`: the same ``scalars.jsonl`` lines, and TensorBoard
  only where ``torch.utils.tensorboard`` imports;
* :func:`copy_opt_file`: the config archived under JAX's header;
* :func:`set_seed`: ``random``, numpy and torch;
* :func:`prepare_environment`: the experiment's directories, seed, logger,
  writer and config archive, JAX's 5-tuple. One process only: the runner's
  multi-process paths wait for ``edtr_torch.parallel``, so an environment
  that asks for more processes raises :class:`NotPortedError`.
"""

from __future__ import annotations

import json
import logging
import os
import random
import shutil
import sys
import time
from typing import Optional

import numpy as np
import torch

from edtr_torch.config import NotPortedError

# the environment variables that ask for more than one process: torchrun's
# and the JAX package's launchers'
WORLD_SIZE_VARS = ("WORLD_SIZE", "EDTR_NUM_PROCESSES", "JAX_NUM_PROCESSES")


def rank() -> int:
    """This process's rank in ``torch.distributed``, 0 without a group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Logger:
    """Rank-0 logger: console INFO and, with ``log_dir``, ``run.log`` DEBUG."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "edtr_torch"):
        self.is_main = rank() == 0
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.DEBUG)
        for handler in list(self._logger.handlers):
            self._logger.removeHandler(handler)
            handler.close()
        self._logger.propagate = False
        if self.is_main:
            fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
            sh = logging.StreamHandler(sys.stdout)
            sh.setLevel(logging.INFO)
            sh.setFormatter(fmt)
            self._logger.addHandler(sh)
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
                fh.setLevel(logging.DEBUG)
                fh.setFormatter(fmt)
                self._logger.addHandler(fh)

    def __call__(self, msg: str, level: str = "info") -> None:
        if self.is_main:
            getattr(self._logger, level)(msg)

    info = __call__


class ScalarWriter:
    """``scalars.jsonl`` lines ``{"tag", "value", "step"}`` (and TensorBoard
    when ``torch.utils.tensorboard`` imports)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_image(self, tag: str, image_hwc, step: int) -> None:
        path = os.path.join(os.path.dirname(self._f.name), f"{tag.replace('/', '_')}_{step}.png")
        save_png(path, image_hwc)
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(image_hwc).transpose(2, 0, 1), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def save_png(path: str, image_hwc) -> None:
    """An HWC image (uint8, or floats in [0, 1]) as a PNG."""
    from PIL import Image

    arr = np.asarray(image_hwc)
    arr = np.clip(arr * 255.0 if arr.dtype != np.uint8 else arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def copy_opt_file(cfg_path: str, exp_dir: str) -> None:
    """The config copied into ``exp_dir`` under a header with the time and
    the command line (JAX's and the reference's ``copy_opt_file``)."""
    os.makedirs(exp_dir, exist_ok=True)
    filename = os.path.join(exp_dir, os.path.basename(cfg_path))
    shutil.copyfile(cfg_path, filename)
    cmd = " ".join(sys.argv)
    stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    with open(filename, "r+") as f:
        content = f.read()
        f.seek(0)
        f.write(f"# GENERATE TIME: {stamp}\n# CMD: {cmd}\n\n{content}")


def set_seed(seed: int) -> None:
    """Seed ``random``, numpy's global state and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def world_size() -> int:
    """The processes this run is asked to span: the process group's size,
    else the largest of :data:`WORLD_SIZE_VARS`, else 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max([int(os.environ.get(v, "1") or 1) for v in WORLD_SIZE_VARS])


def prepare_environment(cfg, cfg_path: Optional[str] = None, seed: Optional[int] = None,
                        device: Optional[torch.device] = None):
    """JAX's ``prepare_environment``: ``exp_dir`` (``train.exp_dir``, else
    the config's), its ``checkpoints`` and ``images``, the seed (``seed``,
    else ``train.seed``, else 231), the logger, the rank-0 writer under
    ``logs``, the config archived; the first line names ``device``'s card
    (where JAX names the TPU). Returns (exp_dir, ckpt_dir, img_dir, logger,
    writer). Raises :class:`NotPortedError` when the environment asks for
    more than one process (:func:`world_size`)."""
    n = world_size()
    if n > 1:
        raise NotPortedError(f"a run over {n} processes needs edtr_torch.parallel, which is "
                             "not ported yet; run one process")
    train_cfg = cfg.get("train", cfg)
    exp_dir = train_cfg.get("exp_dir", "experiments/run")
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    img_dir = os.path.join(exp_dir, "images")
    for d in (exp_dir, ckpt_dir, img_dir):
        os.makedirs(d, exist_ok=True)
    set_seed(seed if seed is not None else train_cfg.get("seed", 231))
    logger = Logger(exp_dir)
    writer = ScalarWriter(os.path.join(exp_dir, "logs")) if logger.is_main else None
    if cfg_path:
        copy_opt_file(cfg_path, exp_dir)
    precision = train_cfg.get("precision", "bf16")
    device = torch.device(device or "cpu")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else f"the {device.type}"
    logger(f"experiment dir: {exp_dir} (precision: {precision} on {where})")
    return exp_dir, ckpt_dir, img_dir, logger, writer
