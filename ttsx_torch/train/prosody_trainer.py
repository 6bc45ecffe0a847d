"""Stage-2 prosody-predictor trainer (``ttsx/train/prosody_trainer.py``).

``ProsodyTrainer(cfg, lr, warmup, total, device, seed)`` trains a fresh
``ProsodyPredictor`` (flax-style init from ``seed``) with AdamW in
optax's semantics on the weighted smooth-L1 ``prosody_loss`` of mel
batches [B, T, n_mels] against targets that ``targets_from_wav`` derives
from the waveform with the DSP frontend.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ttsx_torch.core.config import ProsodyConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.dsp.features import extract_f0_energy
from ttsx_torch.dsp.stft import mfcc
from ttsx_torch.models.prosody import ProsodyPredictor
from ttsx_torch.nn.init import fresh_init_
from ttsx_torch.train import losses as L
from ttsx_torch.train.optim import make_optimizer
from ttsx_torch.train.state import TrainState


def _z(x: torch.Tensor) -> torch.Tensor:
    """Per-utterance z-score over time (population std + 1e-6)."""
    return ((x - x.mean(dim=1, keepdim=True))
            / (x.std(dim=1, keepdim=True, unbiased=False) + 1e-6))


class ProsodyTrainer:
    def __init__(self, cfg: ProsodyConfig = ProsodyConfig(), lr: float = 2e-4,
                 warmup: int = 1000, total: int = 100_000, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = fresh_init_(ProsodyPredictor(cfg),
                            torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.state = TrainState(
            self.model, make_optimizer(self.model.parameters(), lr, warmup,
                                       total), None)

    def _weights(self) -> Dict[str, float]:
        c = self.cfg
        return {"f0": c.f0_weight, "energy": c.energy_weight,
                "pitch_var": c.pitch_var_weight,
                "speech_rate": c.speech_rate_weight,
                "pause_dur": c.pause_dur_weight, "mfcc": c.mfcc_weight}

    def _loss(self, mel, targets, mask):
        d = self.device
        mel = torch.as_tensor(mel, dtype=torch.float32, device=d)
        targets = {k: torch.as_tensor(v, dtype=torch.float32, device=d)
                   for k, v in targets.items()}
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=d)
        return L.prosody_loss(self.model(mel, mask), targets, self._weights(),
                              mask)

    def train_step(self, mel, targets: Dict, mask=None
                   ) -> Dict[str, torch.Tensor]:
        loss = self._loss(mel, targets, mask)
        loss.backward()
        self.state.apply_gradients()
        return {"loss": loss.detach()}

    @torch.no_grad()
    def val_step(self, mel, targets: Dict, mask=None) -> torch.Tensor:
        return self._loss(mel, targets, mask)

    @staticmethod
    def targets_from_wav(wav: torch.Tensor, cfg: ProsodyConfig,
                         frames: int) -> Dict[str, torch.Tensor]:
        """Targets for ``frames`` mel frames of wav [B, N], on its device:
        f0 z-scored over the voiced frames (0 where unvoiced), the z-scored
        log energy and |f0 step|, the speech rate (voicing changes per
        second / 2), the unvoiced share and the mean MFCCs."""
        f0, energy, voiced = (a[:, :frames]
                              for a in extract_f0_energy(wav, cfg.audio))
        vm = voiced.float()
        denom = vm.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (f0 * vm).sum(dim=1, keepdim=True) / denom
        var = ((f0 - mean) ** 2 * vm).sum(dim=1, keepdim=True) / denom
        f0_z = torch.where(voiced, (f0 - mean) / torch.sqrt(var + 1e-6),
                           torch.zeros_like(f0))
        secs = frames * cfg.audio.hop_length / cfg.audio.sample_rate
        trans = torch.diff(vm, dim=1).abs().sum(dim=1, keepdim=True)
        return {
            "f0": f0_z,
            "energy": _z(torch.log(energy + 1e-5)),
            "pitch_var": _z(torch.diff(f0, dim=1, prepend=f0[:, :1]).abs()),
            "speech_rate": trans / (2.0 * secs),
            "pause_dur": 1.0 - vm.mean(dim=1, keepdim=True),
            "mfcc": mfcc(wav, cfg.audio, cfg.n_mfcc)[:, :frames].mean(dim=1),
        }
