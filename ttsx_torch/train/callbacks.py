"""Engine callbacks (``ttsx/train/{engine,callbacks}.py``): the hook
interface, CSV, JSONL and TensorBoard step / validation logging and the
step-time artifact.

``TensorBoardLogger`` raises at construction where
``torch.utils.tensorboard`` does not import; the reference's turns into
a logger that writes nothing.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict


class Callback:
    def on_train_start(self, trainer): ...
    def on_step_end(self, trainer, metrics: Dict): ...
    def on_validation_end(self, trainer, metrics: Dict): ...
    def on_checkpoint(self, trainer, step: int): ...
    def on_train_end(self, trainer): ...


class CSVLogger(Callback):
    """Appends ``{"step", **metrics}`` as a CSV row every ``every`` steps;
    the columns are the first row's, written as the header of a new
    file."""

    def __init__(self, path: str, every: int = 50):
        self.path = Path(path)
        self.every = every
        self._fieldnames = None

    def on_step_end(self, trainer, metrics: Dict):
        if trainer.state.global_step % self.every:
            return
        row = {"step": trainer.state.global_step, **metrics}
        new = not self.path.exists()
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames,
                               extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)


class JSONLLogger(Callback):
    """Appends ``{"step", **metrics}`` every ``every`` steps and
    ``{"step", "val": metrics}`` after each validation."""

    def __init__(self, path: str, every: int = 50):
        self.path = Path(path)
        self.every = every

    def _write(self, record: Dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")

    def on_step_end(self, trainer, metrics: Dict):
        if trainer.state.global_step % self.every == 0:
            self._write({"step": trainer.state.global_step, **metrics})

    def on_validation_end(self, trainer, metrics: Dict):
        self._write({"step": trainer.state.global_step, "val": metrics})


class StepTimeArtifact(Callback):
    """Writes ``step_times.json`` (count, mean, total, the last 200 step
    times in seconds) when training ends."""

    def __init__(self, path: str):
        self.path = Path(path)

    def on_train_end(self, trainer):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        times = trainer.state.step_times
        self.path.write_text(json.dumps({
            "steps": len(times),
            "mean_s": sum(times) / max(len(times), 1),
            "total_s": sum(times),
            "times": times[-200:],
        }))


class TensorBoardLogger(Callback):
    """Writes the int and float metrics as scalars every ``every`` steps,
    and each validation's under ``val/``."""

    def __init__(self, logdir: str, every: int = 50):
        from torch.utils.tensorboard import SummaryWriter
        self.every = every
        self.writer = SummaryWriter(logdir)

    def _scalars(self, prefix: str, metrics: Dict, step: int) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(prefix + k, v, step)

    def on_step_end(self, trainer, metrics: Dict):
        if trainer.state.global_step % self.every == 0:
            self._scalars("", metrics, trainer.state.global_step)

    def on_validation_end(self, trainer, metrics: Dict):
        self._scalars("val/", metrics, trainer.state.global_step)
