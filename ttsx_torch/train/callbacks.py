"""Engine callbacks (``ttsx/train/{engine,callbacks}.py``): the hook
interface, JSONL step / validation logging and the step-time artifact."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict


class Callback:
    def on_train_start(self, trainer): ...
    def on_step_end(self, trainer, metrics: Dict): ...
    def on_validation_end(self, trainer, metrics: Dict): ...
    def on_checkpoint(self, trainer, step: int): ...
    def on_train_end(self, trainer): ...


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
