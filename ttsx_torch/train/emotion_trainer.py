"""Emotion-head trainer (``ttsx/train/emotion_trainer.py``).

``EmotionTrainer`` trains ``EmotionClassifier`` (23 features: 4 VADER
scores and 19 prosody values -> six sigmoid probabilities) together with
``EmotionWeightLearner``, whose gate g blends the inputs as
[vader * g, prosody * (1 - g)], on the binary cross entropy (eps 1e-7)
against multi-hot targets, under one AdamW in optax's semantics.
``params`` holds the two as ``classifier`` and ``weights``, the
reference's tree.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ttsx_torch.core.device import resolve_device
from ttsx_torch.models.prosody import EmotionClassifier, EmotionWeightLearner
from ttsx_torch.nn.init import fresh_init_
from ttsx_torch.train.optim import make_optimizer
from ttsx_torch.train.state import TrainState


class EmotionTrainer:
    def __init__(self, hidden: int = 64, n_emotions: int = 6,
                 lr: float = 1e-3, warmup: int = 100, total: int = 10_000,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        params = nn.ModuleDict({
            "classifier": EmotionClassifier(hidden=hidden,
                                            n_emotions=n_emotions),
            "weights": EmotionWeightLearner()})
        fresh_init_(params, torch.Generator().manual_seed(seed))
        self.params = params.to(self.device)
        self.classifier = self.params["classifier"]
        self.weight_learner = self.params["weights"]
        self.state = TrainState(
            self.params, make_optimizer(self.params.parameters(), lr, warmup,
                                        total), None)

    def predict(self, vader: torch.Tensor, prosody_vec: torch.Tensor
                ) -> torch.Tensor:
        """[B, 4] and [B, 19] -> [B, n_emotions] probabilities."""
        gate = self.weight_learner(vader, prosody_vec)
        return self.classifier(torch.cat([vader * gate,
                                          prosody_vec * (1.0 - gate)], dim=-1))

    def train_step(self, vader, prosody_vec, targets
                   ) -> Dict[str, torch.Tensor]:
        vader, prosody_vec, targets = (
            torch.as_tensor(x, dtype=torch.float32, device=self.device)
            for x in (vader, prosody_vec, targets))
        probs = self.predict(vader, prosody_vec)
        eps = 1e-7
        loss = -(targets * torch.log(probs + eps)
                 + (1 - targets) * torch.log(1 - probs + eps)).mean()
        loss.backward()
        self.state.apply_gradients()
        return {"loss": loss.detach()}
