"""Where a restore or a training step spends its time on the card: a
``torch.profiler`` trace summarised per stage.

:func:`trace_restores` runs a caller's chain (one restore, one restore
and detection, or one training step) under the profiler; the chain puts
each stage under a ``record_function`` range: a restore's named as
``bench.py:_run_split`` names them (:data:`STAGES`, with ``detect`` after
them :data:`RESTORE_DETECT_STAGES`, ``segment`` :data:`RESTORE_SEGMENT_STAGES`,
``classify`` :data:`RESTORE_CLASSIFY_STAGES`), a training step's
:data:`TRAIN_STAGES`, a recipe step's :data:`RECIPE_STAGES`.
:func:`summarise` reads the Chrome trace: per stage the host ms, the
device-busy ms (union of kernel intervals), the idle share, the kernel
count, the host-to-device copies (each one a stall of the host: a copy
from pageable memory synchronises the stream) and the device-to-host
ones; the device time by kernel
family; and the top kernels by device time. ``chip_smoke.py`` prints it for
the full-width 512² restore, restore and detection, segmentation or
classification, and the training steps.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Optional, Sequence

# the ranges set inside a training step (edtr_torch.train.edtr_step): frozen
# SwinIR + encode and each half's forward and loss, the task-net half's
# no-grad walk, the backwards (recomputes included), the optimizers; and
# inside a recipe step (edtr_torch.train.recipes): the frozen
# pre-restoration, the restoration net's forward and loss, backward and
# update, the no-grad restorations for the task net, the task net's half
from edtr_torch.train.common import RECIPE_STAGES, TRAIN_STAGES

# ``text``: the empty prompt's CLIP embedding, which a restore without a
# given c_txt computes after the encode, as JAX's does
STAGES = ("swinir", "vae_encode", "text", "scan", "decode+wavelet")
# restore then detect, bench.py:_run_split's five stages; restore then
# segment, restore then classify (the seg and cls test configs' task nets)
RESTORE_DETECT_STAGES = STAGES + ("detect",)
RESTORE_SEGMENT_STAGES = STAGES + ("segment",)
RESTORE_CLASSIFY_STAGES = STAGES + ("classify",)
# kernel family by substring of the kernel name, first match wins: the
# port's own kernels first, so "gnconv_wgmma_kernel" and "upconv_wgmma_kernel"
# are not booked as cuDNN's convs
FAMILIES = (
    ("swin (edtr_torch)", ("window_attention_kernel", "swin_pre_kernel", "swin_post_kernel")),
    ("flash (edtr_torch)", ("flash_wgmma", "streamkv_kernel", "flash_dq_wgmma",
                            "flash_dkv_wgmma")),
    ("gn_conv (edtr_torch)", ("gnconv_wgmma_kernel", "upconv_wgmma_kernel")),
    ("proj (edtr_torch)", ("lnproj_kernel",)),
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "implicit", "winograd", "nhwc", "nchw")),
    ("gemm (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("norm / reduce", ("reduce", "norm", "softmax")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat", "index",
                            "upsample", "fill", "pad")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _union_ms(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy / 1e3


def summarise(trace: dict, stages: Sequence[str] = STAGES, runs: Optional[int] = None
              ) -> dict:
    """The summary of a trace of ``runs`` runs of a chain whose stages are
    ``stages``, per run (``runs`` None: counted by their first stage; the
    ``*_per_restore`` keys are per run, a restore or a training step)."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in stages]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    htod = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    dtoh = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    # host timestamp of the runtime call that launched each kernel
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    n_runs = runs or max(1, sum(r["name"] == stages[0] for r in ranges))
    per_stage = {}
    for stage in stages:
        wins = [(r["ts"], r["ts"] + r["dur"]) for r in ranges if r["name"] == stage]
        # a kernel or copy belongs to the stage whose host range issued it
        def issued(e):
            ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
            return any(a <= ts <= b for a, b in wins)
        ks = [k for k in kernels if issued(k)]
        wall = sum(b - a for a, b in wins) / 1e3
        busy = _union_ms((k["ts"], k["ts"] + k["dur"]) for k in ks)
        per_stage[stage] = dict(host_ms=wall / n_runs, device_busy_ms=busy / n_runs,
                                idle_share=1 - busy / wall if wall else None,
                                kernels=len(ks) // n_runs,
                                htod_memcpy=sum(issued(e) for e in htod) / n_runs,
                                dtoh_memcpy=sum(issued(e) for e in dtoh) / n_runs)
    by_family, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_family[_family(k["name"])] += k["dur"] / 1e3 / n_runs
        by_name[k["name"]][0] += k["dur"] / 1e3 / n_runs
        by_name[k["name"]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return dict(
        stages=per_stage,
        device_ms_per_restore=sum(by_family.values()),
        kernels_per_restore=len(kernels) // n_runs,
        by_family_ms=dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=n[:120], ms_per_restore=v[0], calls=v[1] // n_runs)
                     for n, v in top])


def trace_restores(chain: Callable[[], None], iters: int,
                   stages: Sequence[str] = STAGES) -> dict:
    """:func:`summarise` of ``iters`` calls of ``chain`` (one restore or one
    training step, its stages under ``stages`` ranges) traced on the host
    and the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            chain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return summarise(json.load(f), stages, iters)
    finally:
        os.remove(path)
