"""The acoustic and refiner train blocks (``ttsx/train/blocks.py``).

Each block owns its model (fresh flax-style init from ``TrainConfig.seed``
on the CPU, then moved to its device), an optimizer with optax's
semantics, and one ``torch.Generator`` on its device behind
``state.draws``, which makes every random draw of its training forward.
Tests and ``chip_smoke.py`` swap ``state.draws`` for a ``ReplayDraws``
to run a step on given draws.

Batches are dicts of numpy arrays or tensors (``as_tensors`` moves them).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.models.acoustic import AcousticModel
from ttsx_torch.models.refiner import ScoreSDERefiner
from ttsx_torch.nn.draws import Draws
from ttsx_torch.nn.init import fresh_init_
from ttsx_torch.train import losses as L
from ttsx_torch.train.optim import make_optimizer
from ttsx_torch.train.state import TrainState

_INT_KEYS = ("style_id",)


def as_tensors(batch: Dict, device) -> Dict:
    """The array entries of ``batch`` as tensors on ``device`` (f32, ids
    int64, masks bool); other entries are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif isinstance(v, np.ndarray):
            t = torch.as_tensor(v, device=device)
            if k in _INT_KEYS:
                t = t.long()
            elif t.is_floating_point():
                t = t.float()
            out[k] = t
    return out


class _Block:
    def __init__(self, cfg: TTSXConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = self.build(cfg)
        fresh_init_(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        tr = cfg.train
        gen = torch.Generator(self.device).manual_seed(seed)
        self.state = TrainState(
            self.model,
            make_optimizer(self.model.parameters(), tr.lr, tr.warmup_steps,
                           tr.max_steps, tr.weight_decay, tr.grad_clip),
            Draws(gen))

    def _step(self, loss: torch.Tensor) -> float:
        loss.backward()
        return self.state.apply_gradients()


class AcousticBlock(_Block):
    """Trains the acoustic model on the composite loss."""

    def build(self, cfg):
        return AcousticModel(cfg.acoustic)

    def _loss(self, b: Dict):
        c = self.cfg.acoustic
        out = self.model(b["text_emb"], b["prosody"], b["emotion_probs"],
                         speaker=b.get("speaker"), target_mel=b["mel"],
                         draws=self.state.draws)
        loss, parts = L.composite_acoustic_loss(
            out, b["mel"], c.w_mel, c.w_mse, c.w_disc, c.w_diff, c.w_emo,
            mask=b.get("frame_mask"))
        return loss, parts, out.mel

    def train_step(self, batch: Dict) -> Dict:
        b = as_tensors(batch, self.device)
        loss, parts, mel = self._loss(b)
        lr = self._step(loss)
        metrics = {"loss": loss.detach(),
                   **{k: torch.as_tensor(v).detach() for k, v in parts.items()}}
        return {"metrics": metrics, "mel_pred": mel.detach(), "lr": lr}

    def train_step_accum(self, batches: Sequence[Dict]) -> Dict:
        """One update from the mean gradient of the micro-batches, which may
        differ in length. Every micro-batch runs on the same draws (the
        reference reuses one key per window); ``mel_pred`` lists each
        micro-batch's own prediction."""
        mark = self.state.draws.mark()
        total, mels = 0.0, []
        for i, batch in enumerate(batches):
            if i:
                self.state.draws.rewind(mark)
            loss, _, mel = self._loss(as_tensors(batch, self.device))
            loss.backward()
            total = total + loss.detach()
            mels.append(mel.detach())
        n = len(batches)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(n)
        lr = self.state.apply_gradients()
        return {"metrics": {"loss": total / n}, "mel_pred": mels, "lr": lr}

    @torch.no_grad()
    def val_step(self, batch: Dict) -> Dict:
        b = as_tensors(batch, self.device)
        out = self.model(b["text_emb"], b["prosody"], b["emotion_probs"],
                         speaker=b.get("speaker"))
        return {"val_l1": (out.mel - b["mel"]).abs().mean(),
                "mel_pred": out.mel}


class RefinerBlock(_Block):
    """Trains the refiner to denoise the acoustic mel: L1 to the target
    blended with score matching against the injected noise, plus the VQ
    commitment loss; the forward advances the VQ's EMA codebooks.
    ``noise_scale`` and ``l1_weight`` come from the engine."""

    def build(self, cfg):
        return ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim,
                               cfg.acoustic.cond_dim)

    def train_step(self, batch: Dict, mel_pred: torch.Tensor,
                   noise_scale: float, l1_weight: float) -> Dict:
        b = as_tensors(batch, self.device)
        draws = self.state.draws
        B = mel_pred.shape[0]
        t = draws.uniform((B, 1))
        noise = draws.normal(mel_pred.shape)
        eps = noise_scale * torch.sqrt(t)[:, :, None] * noise
        out = self.model(mel_pred + eps, b["prosody"], b["style_id"],
                         b["text_emb"], t=t, draws=draws)
        loss, parts = L.refiner_loss(out.mel_ref, b["mel"], out.vq_loss,
                                     l1_weight=l1_weight,
                                     sde_weight=1.0 - l1_weight,
                                     score=out.score, noise=eps)
        lr = self._step(loss)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        return {"metrics": metrics, "lr": lr}

    @torch.no_grad()
    def val_step(self, batch: Dict, mel_pred: torch.Tensor) -> Dict:
        b = as_tensors(batch, self.device)
        out = self.model(mel_pred, b["prosody"], b["style_id"], b["text_emb"])
        return {"val_l1": (out.mel_ref - b["mel"]).abs().mean(),
                "mel_ref": out.mel_ref}


BLOCKS = {"acoustic": AcousticBlock, "refiner": RefinerBlock}
