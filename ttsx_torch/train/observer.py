"""Training-loop observer (``ttsx/train/observer.py``): a per-stage
pre-forward batch transform.

The transform is a callable ``(stage, batch) -> batch`` given directly
or as a ``"module:attr"`` path, gated by a policy dict:

  policy = {"stages": ["acoustic", "vocoder"],  # default: all
            "every": 1,                          # apply every N steps
            "train": True, "val": True}

The engine (``UnifiedTrainer(observer=...)``) applies it on the host to
each stage's batch before that stage's step, in training and in
validation. A transform that returns None leaves the batch as it was;
one that raises is counted in ``errors`` and leaves it too, so a user
hook cannot stop a run.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional, Sequence, Union

Transform = Callable[[str, Dict], Dict]


def _resolve(target: Union[str, Transform]) -> Transform:
    if callable(target):
        return target
    if not isinstance(target, str) or ":" not in target:
        raise ValueError(
            "observer target must be a callable or a 'module:attr' path, "
            f"got {target!r}")
    mod_name, attr = target.split(":", 1)
    fn = getattr(importlib.import_module(mod_name), attr)
    if not callable(fn):
        raise TypeError(f"observer target {target!r} is not callable")
    return fn


class Observer:
    """Observer(module_path_or_callable, policy).pre_forward(stage, batch).

    `pre_forward` returns the (possibly transformed) batch; exceptions in
    the transform are contained (the reference engine must not die to a
    user hook) and counted in `self.errors`.
    """

    def __init__(self, target: Union[str, Transform],
                 policy: Optional[Dict] = None):
        self.fn = _resolve(target)
        policy = dict(policy or {})
        stages: Optional[Sequence[str]] = policy.get("stages")
        self.stages = set(stages) if stages is not None else None
        self.every = max(int(policy.get("every", 1)), 1)
        self.on_train = bool(policy.get("train", True))
        self.on_val = bool(policy.get("val", True))
        self.calls = 0
        self.errors = 0

    def _active(self, stage: str, step: int, training: bool) -> bool:
        if training and not self.on_train:
            return False
        if not training and not self.on_val:
            return False
        if self.stages is not None and stage not in self.stages:
            return False
        return step % self.every == 0

    def pre_forward(self, stage: str, batch: Dict, step: int = 0,
                    training: bool = True) -> Dict:
        if not self._active(stage, step, training):
            return batch
        try:
            out = self.fn(stage, batch)
            self.calls += 1
            return out if out is not None else batch
        except Exception:
            self.errors += 1
            return batch
