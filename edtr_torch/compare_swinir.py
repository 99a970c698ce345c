"""SwinIR of another checkout of this repository against this one's, on one
card: the full-width EDTR SwinIR (C 180, 8 RSTB x 6, window 8) at 512²,
bs 1, bf16, on the same seeded random weights and input.

    git archive <commit> edtr_torch | tar -x -C <dir>
    python3 -m edtr_torch.compare_swinir <dir>

Prints the relative L2 of each output against the other checkout's, the
host ms per forward of each in turns (median of ``--rounds``; host clock
around synchronised calls), and from a ``torch.profiler`` trace of three
forwards each: kernels, memory copies by kind and device-busy ms per
forward. Sides: ``other`` (the other checkout, stock), ``this`` (stock)
and ``this+swin`` (inside ``layers.fused_swin``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _load(root: Path):
    """(models.swinir, models.layers, pipeline) of the checkout at ``root``."""
    for name in [m for m in sys.modules if m.split(".")[0] == "edtr_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        import edtr_torch.models.layers as layers
        import edtr_torch.models.swinir as swinir
        import edtr_torch.pipeline as pipeline
    finally:
        sys.path.remove(str(root))
    return swinir, layers, pipeline


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_swinir: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    this = Path(__file__).resolve().parent.parent
    s0, l0, p0 = _load(args.other.resolve())
    net0 = s0.SwinIR(dtype=torch.bfloat16, **p0.flagship_configs()["swinir"]).to(dev)
    l0.randomize_(net0, torch.Generator(device=dev).manual_seed(0)).eval()
    s1, l1, p1 = _load(this)
    net1 = s1.SwinIR(dtype=torch.bfloat16, **p1.flagship_configs()["swinir"]).to(dev)
    net1.load_state_dict(net0.state_dict())
    net1.eval()
    x = torch.rand((1, 3, 512, 512), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)

    def run(side: str) -> torch.Tensor:
        with torch.no_grad():
            if side == "other":
                return net0(x)
            with l1.fused_swin(side == "this+swin"):
                return net1(x)

    def host_ms(side: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(side)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    sides = ("other", "this", "this+swin")
    outs = {s: run(s).float() for s in sides}
    for s in sides[1:]:
        rel = ((outs[s] - outs["other"]).norm() / outs["other"].norm()).item()
        print(f"{s} vs other: relative L2 {rel}", flush=True)
    ms = {s: [] for s in sides}
    for i in range(args.rounds):  # in turns, the order reversed every other round
        for s in (sides if i % 2 == 0 else sides[::-1]):
            ms[s].append(host_ms(s))
    for s in sides:
        print(f"{s}: host ms per forward, median {statistics.median(ms[s])} of {ms[s]}",
              flush=True)
    for s in sides:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(s)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
        print(f"{s}: per forward {len(kernels) / 3} kernels, copies "
              f"{ {c: copies.count(c) / 3 for c in sorted(set(copies))} }, device busy "
              f"{sum(e['dur'] for e in kernels) / 3e3} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
