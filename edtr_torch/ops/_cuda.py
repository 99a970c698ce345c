"""Build and load the port's hand-written CUDA kernels.

Each ``edtr_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``edtr_torch/_build/<name>-<hash>.so``
at first use, then loaded with ``ctypes``. The file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel or header is rebuilt and a stale library is never loaded. Nothing is
compiled when a module is imported; :func:`build_all` runs one ``nvcc`` per
source, all at once. :func:`arrival_counters` holds the zeroed counters the
kernels that combine split work by a last arrival share on a stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple


_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

SMS = 132  # streaming multiprocessors of an H100 SXM

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_counters: Dict[Tuple[object, int], object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build edtr_torch's kernels (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    seconds ``nvcc`` took (0.0 if nothing was built); raises with the
    compiler's output if it fails. ``ptxas`` register/spill lines go to
    ``<so>.log`` beside the library."""
    out = so_path(name)
    if out.exists():
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return time.perf_counter() - t0


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """:func:`build` of each source, the ``nvcc`` runs started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(so_path(name)))
            _libs[name] = lib
        return lib


def arrival_counters(device, stream: int):
    """4 x :data:`SMS` zeroed int32 arrival counters of one CUDA stream, for
    kernels whose blocks count their arrivals (K5/K6's split K, K3's split
    KV) and leave the counters zeroed: launches on a stream run one after
    another, so no two use them at once."""
    import torch

    key = (device, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(4 * SMS, dtype=torch.int32, device=device)
    return _counters[key]
