"""The train blocks (``ttsx/train/blocks.py``): acoustic, refiner and the
vocoder GAN.

Each block owns its model (fresh flax-style init from ``TrainConfig.seed``
on the CPU, then moved to its device), an optimizer with optax's
semantics, and one ``torch.Generator`` on its device behind
``state.draws``, which makes every random draw of its training forward.
Tests and ``chip_smoke.py`` swap ``state.draws`` for a ``ReplayDraws``
to run a step on given draws. The vocoder block has six parts: the
generator (with an EMA), the GST, the three discriminators, each with its
own optimizer and update count, and the frozen STFT loss; its draws are
the generator's (``states["gen"].draws``).

Batches are dicts of numpy arrays or tensors (``as_tensors`` moves them).

Under an active mesh (``ttsx_torch.core.mesh``) a block steps on this
rank's rows: its draws go through ``mesh_draws`` (the global batch's
draws, this rank's rows) and its updates average the gradients over the
ranks (``TrainState.apply_gradients``), so a dp run's states are one
process's.

A block's ``state_dict`` is its checkpoint entry, the reference's block
state: the acoustic and refiner blocks' one ``TrainState``; the vocoder
block's five (``gen``, ``gst``, ``mpd``, ``msd``, ``mbd``) and the STFT
loss's filterbank (``stft``), as the reference's ``VocoderStates``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.models.acoustic import AcousticModel
from ttsx_torch.models.discriminators import (MultiBandDiscriminator,
                                              MultiPeriodDiscriminator,
                                              MultiScaleDiscriminator,
                                              STFTLoss)
from ttsx_torch.models.refiner import ScoreSDERefiner
from ttsx_torch.models.vocoder import Generator
from ttsx_torch.nn.gst import GlobalStyleTokens
from ttsx_torch.nn.draws import Draws, mesh_draws
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

    def state_dict(self) -> Dict:
        return self.state.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        self.state.load_state_dict(state)


class AcousticBlock(_Block):
    """Trains the acoustic model on the composite loss."""

    def build(self, cfg):
        return AcousticModel(cfg.acoustic)

    def _loss(self, b: Dict):
        c = self.cfg.acoustic
        out = self.model(b["text_emb"], b["prosody"], b["emotion_probs"],
                         speaker=b.get("speaker"), target_mel=b["mel"],
                         draws=mesh_draws(self.state.draws))
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
        draws = mesh_draws(self.state.draws)
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


# the entries of a trainer batch that run along the mel's frame axis
FRAME_KEYS = ("mel", "mel_ref", "prosody", "text_emb", "frame_mask", "f0",
              "energy", "pitch", "pitch_pred", "duration", "duration_pred")


def match_lengths(batch: Dict, hop: int) -> Dict:
    """The vocoder's length rule: T = min(mel frames, wav samples // hop);
    every entry on the frame axis cut to T frames and the wav to T * hop
    samples. A collated bucket of N samples has N // hop + 1 frames, one
    more than the generator can match; a batch whose lengths already
    match passes unchanged."""
    T = min(batch["mel"].shape[1], batch["wav"].shape[1] // hop)
    out = dict(batch)
    for k in FRAME_KEYS:
        if k in out and out[k].ndim >= 2:
            out[k] = out[k][:, :T]
    out["wav"] = out["wav"][:, :T * hop]
    return out


@contextlib.contextmanager
def frozen(*modules: torch.nn.Module):
    """The modules' parameters take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class VocoderBlock:
    """G + GST against the period, scale and band discriminators, with an
    EMA of the generator (``ttsx/train/blocks.py::VocoderBlock``).

    ``disc_step`` updates the three discriminators on the hinge loss of
    real against a fake synthesized without a gradient, plus R1 =
    0.5 * ``r1_gamma`` * the batch mean of ||d(sum of the period and scale
    logits on the real wav)/d wav||^2, taken by double backward on the
    steps where ``mpd``'s count is a multiple of ``r1_interval`` (the
    reference takes it every step and multiplies by 0 elsewhere: the same
    values and gradients); the band discriminator is not in R1.
    ``gen_step`` updates the generator and the GST on the hinge adversarial
    term times ``adversarial_warmup`` of the generator's count before the
    update (0 at the first), ``lambda_fm`` x feature matching against the
    detached real maps, the STFT loss, and the energy, pitch and duration
    terms when configured and present. Both synthesize with the GST style
    of ``mel_ref`` (or ``mel``) and CFG dropout: two Bernoulli(1 -
    ``dropout_prob``) masks of shape [B, 1] on the style and the emotion,
    style first. Both apply ``match_lengths`` first.

    The generator trains on the plain PyTorch path whatever the config's
    kernel flags say: K1 and K2 are forward-only."""

    PARTS = ("gen", "gst", "mpd", "msd", "mbd")

    def __init__(self, cfg: TTSXConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        vc = self.vc = dataclasses.replace(
            cfg.vocoder, use_pallas_upsample=False,
            use_pallas_resblock_stack=False)
        self.hop = math.prod(vc.upsample_factors)
        modules = {
            "gen": Generator(vc, cfg.acoustic.cond_dim,
                             cfg.acoustic.emotion_dim),
            "gst": GlobalStyleTokens(vc.channels, vc.style_dim,
                                     vc.num_style_tokens),
            "mpd": MultiPeriodDiscriminator(vc),
            "msd": MultiScaleDiscriminator(vc),
            "mbd": MultiBandDiscriminator(vc)}
        init = torch.Generator().manual_seed(seed)
        tr = cfg.train
        self.states = {}
        for name, module in modules.items():
            fresh_init_(module, init)
            module.to(self.device)
            draws = (Draws(torch.Generator(self.device).manual_seed(seed))
                     if name == "gen" else None)
            self.states[name] = TrainState(
                module,
                make_optimizer(module.parameters(), tr.lr, tr.warmup_steps,
                               tr.max_steps, tr.weight_decay, tr.grad_clip),
                draws, ema_decay=vc.ema_decay if name == "gen" else 0.0)
        self.gen, self.gst, self.mpd, self.msd, self.mbd = (
            modules[n] for n in self.PARTS)
        self.stft = STFTLoss(vc).to(self.device)

    def _synthesize(self, b: Dict) -> torch.Tensor:
        mel = b["mel_ref"] if "mel_ref" in b else b["mel"]
        style = self.gst(mel)
        draws = mesh_draws(self.states["gen"].draws)
        keep = 1.0 - self.vc.dropout_prob
        style = style * draws.bernoulli(keep, (style.shape[0], 1)).to(
            style.dtype)
        emotion = b["emotion_probs"] * draws.bernoulli(
            keep, (mel.shape[0], 1)).to(mel.dtype)
        scale = b.get("mel_scale") if self.vc.scale_cond else None
        return self.gen(mel, b["prosody"], style, emotion, scale=scale)

    def _batch(self, batch: Dict) -> Dict:
        return match_lengths(as_tensors(batch, self.device), self.hop)

    def disc_step(self, batch: Dict) -> Dict:
        vc = self.vc
        b = self._batch(batch)
        with torch.no_grad():
            wav_fake = self._synthesize(b)
        wav_real = b["wav"]
        apply_r1 = self.states["mpd"].step % vc.r1_interval == 0
        if apply_r1:
            wav_real = wav_real.detach().requires_grad_()
        rl1, _ = self.mpd(wav_real)
        fl1, _ = self.mpd(wav_fake)
        rl2, _ = self.msd(wav_real)
        fl2, _ = self.msd(wav_fake)
        rl3, _ = self.mbd(wav_real)
        fl3, _ = self.mbd(wav_fake)
        d = L.hinge_d_loss(rl1 + rl2 + rl3, fl1 + fl2 + fl3)
        if apply_r1:
            score = sum(l.sum() for l in rl1 + rl2)
            r1 = 0.5 * vc.r1_gamma * L.r1_from_scores(score, wav_real)
        else:
            r1 = torch.zeros((), device=self.device)
        total = d + r1
        total.backward()
        for name in ("mpd", "msd", "mbd"):
            self.states[name].apply_gradients()
        return {"d_loss": d.detach(), "r1": r1.detach(),
                "d_total": total.detach()}

    def gen_step(self, batch: Dict) -> Dict:
        vc = self.vc
        b = self._batch(batch)
        wav_real = b["wav"]
        warmup = L.adversarial_warmup(self.states["gen"].step, vc.r1_interval)
        with frozen(self.mpd, self.msd, self.mbd):
            wav_fake = self._synthesize(b)
            fl, ff, rf = [], [], []
            for disc in (self.mpd, self.msd, self.mbd):
                logits, feats = disc(wav_fake)
                with torch.no_grad():
                    _, real_feats = disc(wav_real)
                fl += logits
                ff += feats
                rf += real_feats
            adv = L.hinge_g_loss(fl) * warmup
            fm = L.feature_matching_loss(ff, rf)
            stft = self.stft(wav_fake, wav_real)
            g = adv + vc.lambda_fm * fm + stft
            parts = {"adv": adv, "fm": fm, "stft": stft}
            if vc.lambda_energy > 0.0:
                en = L.log_rms_energy_loss(wav_fake, wav_real)
                g = g + vc.lambda_energy * en
                parts["energy"] = en
            if "pitch_pred" in b:
                p = (b["pitch_pred"] - b["pitch"]).abs().mean()
                d = (b["duration_pred"] - b["duration"]).abs().mean()
                g = g + vc.lambda_pitch * p + vc.lambda_dur * d
                parts.update({"pitch": p, "dur": d})
            g.backward()
        self.states["gen"].apply_gradients()
        self.states["gst"].apply_gradients()
        return {"g_loss": g.detach(),
                **{k: torch.as_tensor(v).detach() for k, v in parts.items()}}

    def zero_grad(self) -> None:
        for st in self.states.values():
            st.module.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        out = {name: st.state_dict() for name, st in self.states.items()}
        out["stft"] = {"params": dict(self.stft.state_dict())}
        return out

    def load_state_dict(self, state: Dict) -> None:
        for name, st in self.states.items():
            st.load_state_dict(state[name])
        self.stft.load_state_dict(state["stft"]["params"], strict=True)
