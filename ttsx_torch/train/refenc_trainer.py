"""Stage-1 speaker-encoder trainer (``ttsx/train/refenc_trainer.py``).

``RefEncTrainer(cfg, device, seed)`` owns ``params``: the encoder
(``model``, a fresh flax-style init from ``seed``) and the loss head, the
ArcFace class weights ``arcface_w`` [num_speakers, speaker_dim]
(glorot-uniform) or GE2E's ``ge2e_w`` and ``ge2e_b``, under one AdamW with
optax's semantics (warmup-cosine, clip ``cfg.grad_clip``) in a
``TrainState``. The steps take mel batches [B, T, n_mels] and speaker
labels:

* ``train_step``: one update on the loss (ArcFace with the margin
  ramped linearly from 0 over ``arcface_margin_warmup`` updates, or
  GE2E);
* ``train_step_mixup``: the ArcFace loss of alpha x mel + (1 - alpha) x
  mel2 against both speakers, combined by the mean alpha;
* ``train_step_accum``: A micro-batches [A, mb, T, n_mels], their
  gradients summed and divided by A, one update;
* ``embed``, ``evaluate_eer`` (all-pairs cosine EER) and ``train()``,
  which keeps the reference's loop: the ``max_steps`` break comes before
  the evaluation, ``best`` is saved on a lower EER and ``final`` at the
  end (``ttsx_torch.train.checkpoint``, tree ``{"refenc": state}``,
  ``extra`` {"best_eer"}).

GE2E takes its speakers and utterances per speaker from the batch's
labels (``losses.speaker_groups``) and raises on a batch that is not
grouped by speaker. The reference derives them from ``cfg.micro_batch``
(``micro_batch // 2`` speakers), which misgroups any other batch.
``train_step_accum`` takes no masks (the reference's accepts them and
drops them).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ttsx_torch.core.config import RefEncConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.eval.metrics import all_pairs_eer
from ttsx_torch.models.reference_encoder import ReferenceEncoder
from ttsx_torch.nn.init import fresh_init_
from ttsx_torch.train import losses as L
from ttsx_torch.train.checkpoint import save_checkpoint
from ttsx_torch.train.optim import make_optimizer
from ttsx_torch.train.state import TrainState

LOSSES = ("arcface", "ge2e")


class RefEncParams(nn.Module):
    """The trainer's parameters, named as the reference's tree: the
    encoder under ``model`` and the loss head beside it."""

    def __init__(self, cfg: RefEncConfig):
        super().__init__()
        if cfg.loss not in LOSSES:
            raise ValueError(f"Unknown loss '{cfg.loss}'")
        self.model = ReferenceEncoder(cfg)
        if cfg.loss == "arcface":
            self.arcface_w = nn.Parameter(
                torch.zeros(cfg.num_speakers, cfg.speaker_dim))
        else:
            self.ge2e_w = nn.Parameter(torch.tensor(cfg.ge2e_init_w))
            self.ge2e_b = nn.Parameter(torch.tensor(cfg.ge2e_init_b))


def _tensor(x, device, dtype) -> torch.Tensor:
    """``x`` (a tensor, an array or a number) on ``device`` as ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, device=device, dtype=dtype)


class RefEncTrainer:
    def __init__(self, cfg: RefEncConfig = RefEncConfig(), device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        params = RefEncParams(cfg)
        gen = torch.Generator().manual_seed(seed)
        fresh_init_(params.model, gen)
        if cfg.loss == "arcface":
            limit = math.sqrt(6.0 / sum(params.arcface_w.shape))
            with torch.no_grad():
                params.arcface_w.copy_(
                    (torch.rand(params.arcface_w.shape, generator=gen) * 2
                     - 1) * limit)
        self.params = params.to(self.device)
        self.model = self.params.model
        self.state = TrainState(
            self.params,
            make_optimizer(self.params.parameters(), cfg.lr, cfg.warmup_steps,
                           cfg.total_steps, grad_clip=cfg.grad_clip), None)

    def _margin(self, step: int) -> float:
        """The ArcFace margin at update ``step``: linear from 0 to
        ``arcface_margin`` over ``arcface_margin_warmup`` updates, in f32
        as the reference computes it."""
        cfg = self.cfg
        if cfg.arcface_margin_warmup <= 0:
            return cfg.arcface_margin
        frac = min(np.float32(step) / np.float32(cfg.arcface_margin_warmup),
                   np.float32(1.0))
        return float(np.float32(cfg.arcface_margin) * frac)

    def _loss(self, mel, labels, mask=None, labels2=None, alpha=None):
        cfg, p = self.cfg, self.params
        emb = self.model(mel, mask)
        if cfg.loss == "ge2e":
            return L.ge2e_loss(emb, labels, p.ge2e_w, p.ge2e_b)
        margin = self._margin(self.state.step)
        loss = L.arcface_loss(emb, labels, p.arcface_w, margin,
                              cfg.arcface_scale)
        if labels2 is not None:
            loss2 = L.arcface_loss(emb, labels2, p.arcface_w, margin,
                                   cfg.arcface_scale)
            loss = alpha * loss + (1.0 - alpha) * loss2
        return loss

    def _inputs(self, mel, labels=None, mask=None):
        d = self.device
        return (_tensor(mel, d, torch.float32),
                None if labels is None else _tensor(labels, d, torch.long),
                None if mask is None else _tensor(mask, d, torch.bool))

    def train_step(self, mel, labels, mask=None) -> Dict[str, torch.Tensor]:
        loss = self._loss(*self._inputs(mel, labels, mask))
        loss.backward()
        self.state.apply_gradients()
        return {"loss": loss.detach()}

    def train_step_mixup(self, mel, mel2, labels, labels2, alpha
                         ) -> Dict[str, torch.Tensor]:
        """Beta-mixup step; ``alpha`` [B] or a scalar."""
        mel, labels, _ = self._inputs(mel, labels)
        mel2, labels2, _ = self._inputs(mel2, labels2)
        alpha = _tensor(alpha, self.device, torch.float32)
        a = alpha.reshape(-1, 1, 1)
        loss = self._loss(a * mel + (1.0 - a) * mel2, labels, None, labels2,
                          alpha.mean())
        loss.backward()
        self.state.apply_gradients()
        return {"loss": loss.detach()}

    def train_step_accum(self, mels, labels) -> Dict[str, torch.Tensor]:
        """mels [A, mb, T, F], labels [A, mb]: one update from the mean
        of the A micro-batches' gradients."""
        total = 0.0
        for mel, lab in zip(mels, labels):
            loss = self._loss(*self._inputs(mel, lab))
            loss.backward()
            total = total + loss.detach()
        n = len(mels)
        for p in self.params.parameters():
            if p.grad is not None:
                p.grad.div_(n)
        self.state.apply_gradients()
        return {"loss": total / n}

    @torch.no_grad()
    def embed(self, mel, mask=None) -> torch.Tensor:
        mel, _, mask = self._inputs(mel, mask=mask)
        return self.model(mel, mask)

    def evaluate_eer(self, eval_batches: Iterable[Tuple]) -> float:
        """All-pairs cosine EER of the embeddings of (mel, labels) batches;
        inf when there is none."""
        embs, spks = [], []
        for mel, labels in eval_batches:
            embs.append(self.embed(mel).cpu().numpy())
            spks.append(np.asarray(labels))
        if not embs:
            return float("inf")
        return all_pairs_eer(np.concatenate(embs), np.concatenate(spks))

    def train(self, train_batches: Iterable[Tuple],
              eval_fn: Optional[Callable[["RefEncTrainer"], float]] = None,
              max_steps: Optional[int] = None,
              checkpoint_dir: Optional[str] = None) -> Dict:
        """Steps over (mel, labels) batches; ``eval_fn(trainer)`` gives the
        EER every ``cfg.eval_every`` steps."""
        cfg = self.cfg
        best_eer, step = float("inf"), 0
        for mel, labels in train_batches:
            self.train_step(mel, labels)
            step += 1
            if max_steps and step >= max_steps:
                break
            if eval_fn and cfg.eval_every and step % cfg.eval_every == 0:
                eer = eval_fn(self)
                if eer < best_eer:
                    best_eer = eer
                    if checkpoint_dir:
                        save_checkpoint(checkpoint_dir, "best",
                                        {"refenc": self.state.state_dict()},
                                        step, {"best_eer": best_eer})
        if checkpoint_dir and step:
            save_checkpoint(checkpoint_dir, "final",
                            {"refenc": self.state.state_dict()}, step,
                            {"best_eer": best_eer})
        return {"state": self.state, "steps": step, "best_eer": best_eer}
