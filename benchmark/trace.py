"""The device trace of a stretch of the window and what is read from it.

``torch.profiler`` (CPU and CUDA activities) runs over work the mode
hands it; the raw events give:

- ``kernels``: device seconds and launches by kernel name;
- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets), so overlapping work counts once;
- ``window_s``: the traced stretch's length on the host's clock (it ends in
  a device barrier);
- ``device_ops`` and ``idle_gaps``: the ten costliest kernel names, and the
  device's idle time summed by what the host was doing then (the innermost
  host operation or benchmark span that covers the gap's start).
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Callable, Dict, List

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def traced(work: Callable[[], None]) -> dict:
    """Run ``work`` under the profiler, ending in a device barrier, and
    read the trace."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events(), window_s)


def summarize(events, window_s: float) -> dict:
    dev, host = [], []
    kernels: Dict[str, List[float]] = {}
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if dur <= 0 or e.is_user_annotation():
                continue
            dev.append((start, start + dur))
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += dur * 1e-9
            k[1] += 1
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    dev.sort()
    merged: List[List[int]] = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            hs, he, name = host[j]
            if he >= a and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        name = best[2] if best else "(no host span)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"kernels": {k: tuple(v) for k, v in kernels.items()},
            "busy_s": busy_s, "window_s": window_s,
            "device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]}


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose names match any of ``patterns``
    (regular expressions). A pattern that matches no kernel is an error."""
    total = 0.0
    for pat in patterns:
        rx = re.compile(pat)
        hits = [v[0] for k, v in trace["kernels"].items() if rx.search(k)]
        if not hits:
            raise LookupError(f"no kernel in the trace matches {pat!r}")
        total += sum(hits)
    return total
