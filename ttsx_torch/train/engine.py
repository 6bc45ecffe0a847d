"""The unified trainer (``ttsx/train/engine.py``) for the acoustic and
refiner blocks.

Each engine step trains the acoustic block on ``grad_accum_steps``
micro-batches (one update from their mean gradient), then, every
``refiner_update_freq`` steps, the refiner on the step's first
micro-batch and the acoustic prediction for it. ``validate`` runs both
blocks without draws; with ``sde_noise_annealing`` the refiner's noise
scale and L1 weight follow the validation L1. ``ema_swap_validate`` has
nothing to swap: neither block keeps an EMA, so validation reads the
trained weights.

Two departures from the reference, both reference defects:

* micro-batches of different bucket lengths train (the reference stacks
  them with ``jnp.stack``, which raises);
* under accumulation the refiner gets micro-batch 0's own ``mel_pred``
  (the reference pairs micro-batch 0 with the last micro-batch's).

Not ported yet: the vocoder block (``NotImplementedError``), checkpoints,
the observer hook and the data-parallel mesh.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.train.blocks import BLOCKS, as_tensors
from ttsx_torch.train.callbacks import Callback


class TrainerState:
    """Host-side view of the run."""

    def __init__(self):
        self.global_step = 0
        self.best_val = float("inf")
        self.noise_scale = 1.0     # sde_noise_annealing
        self.l1_weight = 1.0       # refiner L1 <-> score-matching blend
        self.step_times: List[float] = []


class UnifiedTrainer:
    """``UnifiedTrainer(cfg, train_iter, val_iter).train()``.

    Block i of ``blocks`` is seeded with ``cfg.train.seed + i``."""

    def __init__(self, cfg: TTSXConfig, train_iter: Iterable[Dict],
                 val_iter=None, callbacks: Optional[List[Callback]] = None,
                 blocks: Iterable[str] = ("acoustic", "refiner"),
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_iter = iter(train_iter)
        # a one-shot generator is kept as a list, so that every validation
        # pass sees every batch
        if (val_iter is not None and not callable(val_iter)
                and iter(val_iter) is val_iter):
            val_iter = list(val_iter)
        self.val_iter = val_iter
        self.callbacks = callbacks or []
        self.state = TrainerState()
        self.blocks = {}
        for i, name in enumerate(blocks):
            if name not in BLOCKS:
                if name == "vocoder":
                    raise NotImplementedError(
                        "the vocoder GAN block is not ported yet")
                raise KeyError(f"unknown train block '{name}'")
            self.blocks[name] = BLOCKS[name](cfg, self.device,
                                             cfg.train.seed + i)

    def train_step(self, batch: Dict) -> Dict:
        t0 = time.perf_counter()
        cfg = self.cfg.train
        metrics: Dict[str, float] = {}
        b = as_tensors(batch, self.device)
        mel_pred = b["mel"]

        if "acoustic" in self.blocks:
            block = self.blocks["acoustic"]
            if cfg.grad_accum_steps > 1:
                micro = [b]
                for _ in range(cfg.grad_accum_steps - 1):
                    try:
                        micro.append(next(self.train_iter))
                    except StopIteration:
                        break
                out = block.train_step_accum(micro)
                mel_pred = out["mel_pred"][0]
            else:
                out = block.train_step(b)
                mel_pred = out["mel_pred"]
            metrics.update({f"acoustic/{k}": float(v)
                            for k, v in out["metrics"].items()})

        if ("refiner" in self.blocks
                and self.state.global_step % cfg.refiner_update_freq == 0):
            out = self.blocks["refiner"].train_step(
                b, mel_pred, self.state.noise_scale, self.state.l1_weight)
            metrics.update({f"refiner/{k}": float(v)
                            for k, v in out["metrics"].items()})

        self.state.global_step += 1
        dt = time.perf_counter() - t0
        self.state.step_times.append(dt)
        metrics["step_time_s"] = dt
        for cb in self.callbacks:
            cb.on_step_end(self, metrics)
        return metrics

    def validate(self) -> Dict:
        if self.val_iter is None or not self.blocks:
            return {}
        vals = []
        batches = self.val_iter() if callable(self.val_iter) else self.val_iter
        for batch in batches:
            b = as_tensors(batch, self.device)
            out = None
            mel_pred = b["mel"]  # refiner alone: refine the ground truth
            if "acoustic" in self.blocks:
                out = self.blocks["acoustic"].val_step(b)
                mel_pred = out["mel_pred"]
            if "refiner" in self.blocks:
                out = self.blocks["refiner"].val_step(b, mel_pred)
            vals.append(float(out["val_l1"]))
        val_l1 = float(np.mean(vals)) if vals else float("inf")
        metrics = {"val_l1": val_l1}
        if self.cfg.train.novel.sde_noise_annealing:
            self.state.noise_scale = float(np.clip(val_l1, 0.05, 1.0))
            self.state.l1_weight = float(np.clip(1.0 - val_l1, 0.1, 1.0))
        if val_l1 < self.state.best_val:
            self.state.best_val = val_l1
            metrics["best"] = True
        for cb in self.callbacks:
            cb.on_validation_end(self, metrics)
        return metrics

    def train(self, max_steps: Optional[int] = None) -> TrainerState:
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        for cb in self.callbacks:
            cb.on_train_start(self)
        batch = next(self.train_iter)
        while self.state.global_step < max_steps:
            self.train_step(batch)
            if cfg.val_freq and self.state.global_step % cfg.val_freq == 0:
                self.validate()
            try:
                batch = next(self.train_iter)
            except StopIteration:
                break
        for cb in self.callbacks:
            cb.on_train_end(self)
        return self.state
