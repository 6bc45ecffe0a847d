"""A traced stretch of whole calls or steps, reduced to what the per-layer
metrics read.

``Stretch`` runs ``torch.profiler`` (host and CUDA activity) around the
calls a driver makes inside it, with the device synchronised at both
ends, and writes the Chrome trace under ``TMPDIR``. ``reduce_trace``
turns the trace into:

* ``kernels``: device seconds and launches by kernel name;
* ``busy_s``: the union of the device's kernel, copy and set intervals;
* ``ranges``: device seconds by the benchmark's own host ranges
  (``record_function`` names), each kernel counted under every range
  open on the host when it was launched;
* ``gaps``: the device's idle time between its busy intervals, by the
  innermost host range or operator open at the gap's middle;
* ``device_ops``: the ten kernels that took most device time.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


class Stretch:
    """``with Stretch(device) as s: ...`` traces the block; afterwards
    ``s.window_s`` is its wall time, and ``s.reduce()`` gives the reduced
    trace."""

    def __init__(self, device: str):
        self.device = device
        self.window_s = 0.0
        self.trace: dict = {}

    def _sync(self):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        """Export the trace under ``TMPDIR``, reduce it and delete the file
        (after the measured window: it takes seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json",
                                    dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        self.trace = reduce_trace(events)
        del self.prof
        return self.trace


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(events: List[dict]) -> dict:
    """The Chrome trace's events (times in microseconds) reduced as the
    module docstring says; every time in seconds."""
    dev, host, launch_ts = [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(ev)
        elif cat in HOST_CATS:
            host.append(ev)
        elif cat == "cuda_runtime":
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(ev["ts"])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    busy = []
    for ev in dev:
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        busy.append((s, s + d))
        if ev.get("cat") == "kernel":
            k = kernels[ev["name"]]
            k[0] += d * 1e-6
            k[1] += 1
    merged = _merge(busy)
    busy_s = sum(e - s for s, e in merged) * 1e-6

    annotations = sorted(
        (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
         ev["name"]) for ev in host if ev.get("cat") == "user_annotation")
    ranges: Dict[str, float] = defaultdict(float)
    for ev in dev:
        corr = ev.get("args", {}).get("correlation")
        ts = launch_ts.get(corr)
        if ts is None:
            continue
        for s, e, name in annotations:
            if s > ts:
                break
            if ts <= e:
                ranges[name] += float(ev.get("dur", 0.0)) * 1e-6

    # what the host was doing in each idle gap: the innermost (shortest)
    # host event open at the gap's middle
    host_iv = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
                      ev["name"]) for ev in host)
    starts = [h[0] for h in host_iv]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in host_iv[max(0, i - 500):i]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        gaps[best[2] if best else "(no host event)"] += (s1 - e0) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "kernels": {k: {"s": v[0], "n": v[1]} for k, v in kernels.items()},
        "busy_s": busy_s,
        "ranges": dict(ranges),
        "device_ops": [[k[:160], v[0]] for k, v in top[:10]],
        "idle_gaps": [[k[:160], v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_time(trace: dict, match) -> Tuple[float, int]:
    """(device seconds, launches) of the kernels whose name ``match``
    accepts."""
    s, n = 0.0, 0
    for name, k in trace.get("kernels", {}).items():
        if match(name):
            s += k["s"]
            n += k["n"]
    return s, n
