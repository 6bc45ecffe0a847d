"""Latency / RTF timers and the CI perf gates (``ttsx/eval/benchmarks.py``).

Host-clock timers: each call's result is waited for with
``torch.cuda.synchronize`` on the device of every CUDA tensor it returns
(nothing is done for CPU tensors), where the reference blocks on its
device arrays.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested sequences and
    dicts walked)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block_until_ready(out):
    """Wait for every CUDA tensor in ``out``; returns ``out``."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn: Callable, *args, runs: int = 20, warmup: int = 2) -> Dict:
    """Wall time of ``fn(*args)`` over ``runs`` calls after ``warmup``,
    each waited for: {"mean_s", "std_s", "min_s", "runs"}."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {"mean_s": float(times.mean()), "std_s": float(times.std()),
            "min_s": float(times.min()), "runs": runs}


def rtf(fn: Callable, *args, audio_seconds: float, runs: int = 10) -> Dict:
    """Real-time factor: ``time_fn``'s mean (``rtf``) and least
    (``rtf_best``) time over ``audio_seconds``."""
    stats = time_fn(fn, *args, runs=runs)
    stats["rtf"] = stats["mean_s"] / audio_seconds
    stats["rtf_best"] = stats["min_s"] / audio_seconds
    return stats


class CIGateError(RuntimeError):
    pass


def ci_latency_gate(model_fn: Callable, baseline_fn: Callable, args_model,
                    args_baseline, factor: float = 20.0, runs: int = 20):
    """{"model", "baseline", "ratio"}; raises ``CIGateError`` if the
    model's mean time exceeds ``factor`` x the baseline's."""
    m = time_fn(model_fn, *args_model, runs=runs)
    b = time_fn(baseline_fn, *args_baseline, runs=runs)
    ratio = m["mean_s"] / max(b["mean_s"], 1e-9)
    if ratio > factor:
        raise CIGateError(
            f"model {m['mean_s']*1e3:.1f}ms > {factor}x baseline "
            f"{b['mean_s']*1e3:.1f}ms (ratio {ratio:.1f})")
    return {"model": m, "baseline": b, "ratio": ratio}


def time_budget_gate(fn: Callable, *args, max_avg_time: float = 0.5,
                     runs: int = 5):
    """``time_fn``'s stats; raises ``CIGateError`` if the mean exceeds
    ``max_avg_time`` seconds."""
    stats = time_fn(fn, *args, runs=runs)
    if stats["mean_s"] > max_avg_time:
        raise CIGateError(
            f"avg {stats['mean_s']:.3f}s exceeds budget {max_avg_time}s")
    return stats
