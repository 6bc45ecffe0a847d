"""Per-stage timings and memory (``ttsx/eval/record_baseline.py``): the
acoustic and refiner blocks' forward and train step, the vocoder block's
``disc_step`` and ``gen_step``, in ms (the mean of 10 calls after one
warm-up, each call followed by a device synchronize, as the reference's
``block_until_ready``), the peak device memory so far after each stage
(``torch.cuda.max_memory_allocated``; None on the CPU), and the unified
iterations per second, at ``TTSXConfig()`` on a synthetic batch.

    python -m ttsx_torch.eval.record_baseline [OUT] [--cpu]

writes OUT (default ``eval_results_torch/results.json``) and prints it.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ttsx_torch.eval.parity_common import experiment_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_mb(dev: torch.device) -> Optional[float]:
    """The peak memory allocated on the card so far, MB; None on the CPU
    (a failure to read it on the card raises)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e6


def _time(fn, dev: torch.device, runs: int = 10) -> float:
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
        _sync(dev)
    return (time.perf_counter() - t0) / runs * 1e3  # ms


def record(frames: int = 128, batch: int = 2, device="cuda") -> Dict:
    from ttsx_torch.core.config import TTSXConfig
    from ttsx_torch.data.synthetic import synthetic_batch
    from ttsx_torch.train.blocks import (AcousticBlock, RefinerBlock,
                                         VocoderBlock, as_tensors)

    dev = experiment_device(device)
    cfg = TTSXConfig()
    b = as_tensors(synthetic_batch(cfg, batch, frames), dev)
    results: Dict = {"config": {"frames": frames, "batch": batch},
                     "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else str(dev))}

    ab = AcousticBlock(cfg, dev, 0)
    results["acoustic"] = {
        "forward_ms": _time(lambda: ab.val_step(b)["val_l1"], dev),
        "train_step_ms": _time(lambda: ab.train_step(b), dev),
        "peak_mb": _device_mb(dev),
    }

    rb = RefinerBlock(cfg, dev, 0)
    mel_pred = b["mel"]
    results["refiner"] = {
        "forward_ms": _time(lambda: rb.val_step(b, mel_pred)["val_l1"], dev),
        "train_step_ms": _time(lambda: rb.train_step(b, mel_pred, 1.0, 1.0),
                               dev),
        "peak_mb": _device_mb(dev),
    }

    vb = VocoderBlock(cfg, dev, 0)
    results["vocoder"] = {
        "disc_step_ms": _time(lambda: vb.disc_step(b), dev),
        "gen_step_ms": _time(lambda: vb.gen_step(b), dev),
        "peak_mb": _device_mb(dev),
    }

    total_ms = (results["acoustic"]["train_step_ms"]
                + results["refiner"]["train_step_ms"]
                + results["vocoder"]["disc_step_ms"]
                + results["vocoder"]["gen_step_ms"])
    results["unified_iters_per_s"] = 1000.0 / total_ms if total_ms else 0.0
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser("record_baseline")
    p.add_argument("out", nargs="?",
                   default="eval_results_torch/results.json")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    args = p.parse_args(argv)
    res = record(device="cpu" if args.cpu else "cuda")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
