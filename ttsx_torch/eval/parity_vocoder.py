"""The vocoder half of the waveform-quality harness
(``ttsx/eval/parity_vocoder.py``): cumulative GAN training with checkpoint
and slim resume, deterministic synthesis, and the copy-synthesis quality
experiment (``vocoder_quality``).

The generator trains on the plain path (``VocoderBlock`` turns both
kernel flags off: K1 and K2 are forward-only). The reference synthesizes
under ``jax.default_matmul_precision("highest")``; the port's numerics
are that already, with TF32 off on the card (``experiment_device``,
``core/device.py::set_f32_numerics``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.eval.parity import _tts_cfg
from ttsx_torch.eval.parity_common import (AUDIO, _batch_sampler,
                                           _model_batch, _normalize_mels,
                                           _wav_quality, experiment_device,
                                           make_corpus, mel_energy_gain)


def _train_vocoder(cfg: TTSXConfig, feats: Dict[str, np.ndarray],
                   steps: int, batch: int, seed: int,
                   save_dir: Optional[str] = None,
                   save_every: int = 2000, device="cuda"):
    """Adversarial training of a ``VocoderBlock``; returns (block,
    seconds, tail metrics).

    ``steps`` is the cumulative target: with ``save_dir`` the checkpoint
    ``vocoder_quality`` there is restored and only the remaining steps
    run, checkpointed every ``save_every`` steps and at the end, each save
    with a slim export ``<save_dir>_slim.npz``. Without the checkpoint, a
    slim export warm-starts the generator and GST (the discriminators and
    optimizers fresh, the step count from 0) and its ``steps`` meta
    carries the training it already holds (``effective_steps``)."""
    from ttsx_torch.train.blocks import VocoderBlock
    from ttsx_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from ttsx_torch.train.slim_export import (load_slim_meta,
                                              load_vocoder_slim,
                                              save_vocoder_slim)

    block = VocoderBlock(cfg, experiment_device(device), seed)
    sampler = _batch_sampler(feats, batch, seed)
    next(sampler)   # the reference's init batch: the steps take the next
    start = base_steps = 0
    slim = f"{save_dir}_slim.npz"
    if save_dir is not None:
        got = restore_checkpoint(save_dir, "vocoder_quality",
                                 block.state_dict())
        if got is not None:
            states, start, extra = got
            block.load_state_dict(states)
            base_steps = int(extra.get("base_steps", 0))
            start = min(int(start), steps)
        elif os.path.exists(slim):
            # also at steps=0: restore and train nothing (an eval-only
            # read of a slim export)
            base_steps = int(load_slim_meta(slim).get("steps", 0))
            load_vocoder_slim(slim, block)
    meta = {"steps": steps}
    if "mel_scale" in feats:
        # the training set's mean scale vector: a scale_cond server's
        # default (a text->wav caller has no target utterance)
        meta["mel_scale_mean"] = feats["mel_scale"].mean(axis=0)

    def save(at_step):
        save_checkpoint(save_dir, "vocoder_quality", block.state_dict(),
                        at_step, extra={"seed": seed, "batch": batch,
                                        "base_steps": base_steps})
        save_vocoder_slim(slim, block, meta=dict(meta,
                                                 steps=base_steps + at_step))

    d_hist, g_hist = [], []
    parts_hist = {"stft": [], "adv": [], "fm": []}
    t0 = time.perf_counter()
    for i in range(steps - start):
        mb = next(sampler)
        dm = block.disc_step(mb)
        gm = block.gen_step(mb)
        d_hist.append(float(dm["d_loss"]))
        g_hist.append(float(gm["g_loss"]))
        for k in parts_hist:
            if k in gm:
                parts_hist[k].append(float(gm[k]))
        done = start + i + 1
        if (save_dir is not None and save_every > 0 and done < steps
                and (done - start) % save_every == 0):
            save(done)
    secs = time.perf_counter() - t0
    if save_dir is not None and steps > start:
        save(steps)
    tail = {}
    if d_hist:
        tail = {"d_loss_tail_mean": float(np.mean(d_hist[-100:])),
                "g_loss_tail_mean": float(np.mean(g_hist[-100:])),
                "stable": bool(np.isfinite(d_hist).all()
                               and np.isfinite(g_hist).all())}
        tail.update({f"{k}_tail_mean": float(np.mean(v[-100:]))
                     for k, v in parts_hist.items() if v})
    if base_steps:
        tail["effective_steps"] = base_steps + steps
    return block, secs, tail


@torch.no_grad()
def _synth_wav(block, mel_norm: np.ndarray, feats: Dict[str, np.ndarray],
               batch: int, use_ema: bool = True,
               scale_override: Optional[np.ndarray] = None) -> np.ndarray:
    """Deterministic mel -> wav [B, N] through the block's generator (its
    EMA, or its live parameters), no CFG dropout, whole batches only.

    ``scale_override`` ([2C] broadcast, or [B, 2C]) replaces the
    per-utterance ``mel_scale`` of a scale_cond generator: text -> wav
    passes the training corpus's mean (no target utterance exists at
    serving), copy-synthesis keeps the per-utterance stats, which are
    model input there."""
    dev = block.device
    params = block.states["gen"].eval_params(use_ema)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    outs = []
    for i in range(0, mel_norm.shape[0], batch):
        mel = t(mel_norm[i:i + batch])
        if mel.shape[0] < batch:
            break
        scale = None
        if block.vc.scale_cond:
            scale = (t(scale_override).expand(batch, -1)
                     if scale_override is not None
                     else t(feats["mel_scale"][i:i + batch]))
        style = block.gst(mel)
        wav = functional_call(block.gen, params, (
            mel, t(feats["prosody"][i:i + batch]), style,
            t(feats["emotion_probs"][i:i + batch])), {"scale": scale})
        outs.append(wav[..., 0].cpu().numpy())
    return np.concatenate(outs)


def vocoder_parity(steps: int = 2000, frames: int = 64, batch: int = 4,
                   n_speakers: int = 4, utts_train: int = 8,
                   utts_eval: int = 12, seed: int = 0,
                   return_states: bool = False,
                   save_dir: Optional[str] = None,
                   vocoder_overrides: Optional[Dict] = None,
                   corpus: str = "tone", device="cuda") -> Dict:
    """The GAN vocoder trained on the corpus; held-out waveform quality
    (``_wav_quality``) of the live and EMA generators, of the EMA's output
    gain-matched to the requested mel's energy (``mel_energy_gain``), and
    of random weights. ``vocoder_overrides`` replaces ``VocoderConfig``
    fields (e.g. {"scale_cond": True}) for ablation legs."""
    dev = experiment_device(device)
    cfg = _tts_cfg()
    if vocoder_overrides:
        cfg = dataclasses.replace(
            cfg, vocoder=dataclasses.replace(cfg.vocoder,
                                             **vocoder_overrides))
    hop = int(np.prod(cfg.vocoder.upsample_factors))
    corpus_kind = corpus
    corpus = make_corpus(corpus, n_speakers=n_speakers, audio=AUDIO,
                         seed=seed)

    def prep(utts):
        full = _normalize_mels(corpus.features(utts, device=dev))
        f = _model_batch(full)
        T = f["mel"].shape[1]
        f["wav"] = f["wav"][:, :T * hop]
        return f, full["mel_raw"][:, :T]

    tr, _ = prep(corpus.utterances(utts_train, frames, seed=seed))
    ev, ev_mel_raw = prep(corpus.utterances(utts_eval, frames,
                                            seed=seed + 1))
    quality = lambda w: _wav_quality(w, ev["wav"][:len(w), :, 0], dev)

    # the random-weight baseline from a fresh init (same seed)
    block, _, _ = _train_vocoder(cfg, tr, 0, batch, seed, device=dev)
    q_rand = quality(_synth_wav(block, ev["mel"], ev, batch, use_ema=False))
    del block

    block, secs, tail = _train_vocoder(cfg, tr, steps, batch, seed,
                                       save_dir=save_dir, device=dev)
    # live parameters: at decay 0.999 the EMA still holds 0.999^steps of
    # the random init after a short run
    wav_fake = _synth_wav(block, ev["mel"], ev, batch, use_ema=False)
    q = quality(wav_fake)
    wav_ema = _synth_wav(block, ev["mel"], ev, batch, use_ema=True)
    q_ema = quality(wav_ema)
    # input-only loudness normalisation: the requested raw mel is model
    # input at copy-synthesis time
    g = mel_energy_gain(wav_ema, ev_mel_raw[:len(wav_ema)], AUDIO, dev)
    q_gm = quality(wav_ema * g[:, None])

    res: Dict = {"exp": "vocoder_quality", "steps": steps,
                 "corpus": corpus_kind,
                 "train_seconds": secs, "eval_utts": int(len(wav_fake)),
                 "space": "generator input is per-utterance-normalized "
                          "log-mel; quality measured on raw waveforms",
                 **q,
                 **{f"{k}_ema": v for k, v in q_ema.items()},
                 **{f"{k}_gm_ema": v for k, v in q_gm.items()},
                 "gain_match_mean": float(g.mean()),
                 **{f"{k}_random_weights": v for k, v in q_rand.items()},
                 **tail}
    if return_states:
        res["_block"], res["_corpus"] = block, corpus
    return res
