"""Parity-number harness (``ttsx/eval/parity.py``): each stage trained on
a synthetic corpus and measured on held-out utterances.

  * refenc:   the speaker encoder (ArcFace or GE2E) -> all-pairs cosine
              EER (``parity_refenc.py``);
  * prosody:  the prosody predictor -> f0 / energy Pearson r
              (``parity_prosody.py``);
  * acoustic: ``AcousticBlock`` text -> mel -> MCD dB (here);
  * refiner:  ``RefinerBlock`` on the trained acoustic's outputs at
              levels 2 and 3 -> MCD after refinement (here);
  * vocoder:  the GAN at the reference's discriminators -> D/G loss tails
              (``parity_aux.py``); its copy-synthesis quality
              (``parity_vocoder.py``);
  * e2e:      text -> waveform through the three trained stages, and the
              zoo export (``parity_e2e.py``);
  * diarizer: DER on a synthetic dialogue, easy and hard
              (``parity_aux.py``, ``parity_diar.py``).

Run: ``python -m ttsx_torch.eval.parity_aux --exp <name>`` (on the card;
``--cpu`` for the CPU). Every experiment takes ``device``, "cuda" by
default. No kernel runs here: the blocks train on the plain path.

A fully resumed ``acoustic_parity`` (its checkpoint already at ``steps``)
reports the loss the checkpoint stored, or None, where the reference
reports NaN, which is not JSON.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ttsx_torch.core.config import TTSXConfig, tts_cfg
from ttsx_torch.eval.parity_common import (AUDIO, _acoustic_preds,
                                           _batch_sampler, _denorm_mcd,
                                           _model_batch, _normalize_mels,
                                           _speaker_vec, experiment_device,
                                           make_corpus)


def _tts_cfg(levels: int = 2) -> TTSXConfig:
    """The config the checked-in zoo was trained with (``tts_cfg``)."""
    return tts_cfg(levels)


def _acoustic_data(n_speakers: int, utts_train: int, utts_eval: int,
                   frames: int, seed: int, cfg: TTSXConfig,
                   corpus: str = "tone", device="cuda"):
    corpus = make_corpus(corpus, n_speakers=n_speakers,
                         text_dim=cfg.acoustic.text_emb_dim,
                         audio=AUDIO, seed=seed)
    tr = _normalize_mels(corpus.features(
        corpus.utterances(utts_train, frames, seed=seed), device=device))
    ev = _normalize_mels(corpus.features(
        corpus.utterances(utts_eval, frames, seed=seed + 1), device=device))
    for d in (tr, ev):
        d["speaker"] = _speaker_vec(d["speaker_id"],
                                    cfg.acoustic.speaker_dim, n_speakers)
    return corpus, tr, ev


def _mcds(pred: np.ndarray, data: Dict, start: int) -> list:
    from ttsx_torch.eval.metrics import mel_cepstral_distortion
    return [_denorm_mcd(pred[j], data, start + j, mel_cepstral_distortion)
            for j in range(pred.shape[0])]


def acoustic_parity(n_speakers: int = 8, utts_train: int = 24,
                    utts_eval: int = 8, frames: int = 128,
                    steps: int = 4000, batch: int = 16, seed: int = 0,
                    return_states: bool = False,
                    corpus: str = "tone",
                    save_dir: Optional[str] = None,
                    device="cuda") -> Dict:
    from ttsx_torch.train.blocks import AcousticBlock
    from ttsx_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)

    dev = experiment_device(device)
    cfg = _tts_cfg()
    corpus, tr, ev = _acoustic_data(n_speakers, utts_train, utts_eval,
                                    frames, seed, cfg, corpus=corpus,
                                    device=dev)
    block = AcousticBlock(cfg, dev, seed)
    sampler = _batch_sampler(_model_batch(tr), batch, seed)
    next(sampler)   # the reference's init batch: the steps take the next

    def eval_mcd(data):
        mcds = []
        mb_all = _model_batch(data)
        for i in range(0, len(data["mel"]), batch):
            mb = {k: v[i:i + batch] for k, v in mb_all.items()}
            if mb["mel"].shape[0] < batch:
                break
            mcds += _mcds(block.val_step(mb)["mel_pred"].cpu().numpy(),
                          data, i)
        return float(np.mean(mcds))

    mcd_random = eval_mcd(ev)
    # resumable: a run stopped by its time limit keeps its progress
    start, loss = 0, None
    if save_dir is not None:
        got = restore_checkpoint(save_dir, "acoustic", block.state_dict())
        if got is not None:
            states, start, extra = got
            block.load_state_dict(states)
            start, loss = min(int(start), steps), extra.get("loss")

    def save(at):
        save_checkpoint(save_dir, "acoustic", block.state_dict(), at,
                        extra={"loss": loss})

    t0 = time.perf_counter()
    for step in range(steps - start):
        out = block.train_step(next(sampler))
        loss = float(out["metrics"]["loss"])
        done = start + step + 1
        if save_dir is not None and done < steps and done % 1000 == 0:
            save(done)
    if save_dir is not None and steps > start:
        save(steps)
    train_s = time.perf_counter() - t0
    res = {"exp": "acoustic", "mcd_db": eval_mcd(ev),
           "mcd_random_weights_db": mcd_random, "final_loss": loss,
           "steps": steps, "train_seconds": train_s,
           "space": "trained on per-utterance-normalized log-mel; MCD "
                    "measured on de-normalized (raw log-mel) frames",
           "eval_utts": len(ev["mel"])}
    if return_states:
        res["_block"] = block
        res["_data"] = (corpus, tr, ev)
        res["_cfg"] = cfg
    return res


def _refiner_steps(block, tr_model: Dict, tr_pred: np.ndarray, batch: int,
                   rng: np.random.Generator, steps: int, on_step=None):
    """``steps`` refiner updates on random rows of the acoustic's own
    predictions (noise scale 0.3, L1 weight 0.9); returns the last
    metrics."""
    m = None
    for it in range(steps):
        idx = rng.integers(0, len(tr_pred), batch)
        mb = {k: v[idx] for k, v in tr_model.items()}
        m = block.train_step(mb, torch.as_tensor(tr_pred[idx],
                                                 device=block.device),
                             0.3, 0.9)
        if on_step is not None:
            on_step(it)
    return m


def refiner_parity(levels: Sequence[int] = (2, 3), steps: int = 2400,
                   acoustic_steps: int = 4000, batch: int = 8,
                   frames: int = 128, seed: int = 0,
                   corpus: str = "tone", device="cuda") -> Dict:
    from ttsx_torch.train.blocks import RefinerBlock

    base = acoustic_parity(steps=acoustic_steps, batch=16, frames=frames,
                           seed=seed, return_states=True, corpus=corpus,
                           device=device)
    a_block = base["_block"]
    corpus, tr, ev = base["_data"]
    tr_pred, tr_cut = _acoustic_preds(a_block, tr, batch)
    ev_pred, ev_cut = _acoustic_preds(a_block, ev, batch)

    out: Dict = {"exp": "refiner", "acoustic_mcd_db": base["mcd_db"],
                 "space": base["space"], "levels": {},
                 # the full acoustic record (the same training run)
                 "acoustic": {k: v for k, v in base.items()
                              if not k.startswith("_")}}
    tr_model, ev_model = _model_batch(tr_cut), _model_batch(ev_cut)
    for lv in levels:
        block = RefinerBlock(_tts_cfg(levels=lv), a_block.device, seed)
        t0 = time.perf_counter()
        m = _refiner_steps(block, tr_model, tr_pred, batch,
                           np.random.default_rng(seed), steps)
        train_s = time.perf_counter() - t0
        mcds = []
        for i in range(0, len(ev_pred), batch):
            mb = {k: v[i:i + batch] for k, v in ev_model.items()}
            if mb["mel"].shape[0] < batch:
                break
            pred = torch.as_tensor(ev_pred[i:i + batch], device=block.device)
            mcds += _mcds(block.val_step(mb, pred)["mel_ref"].cpu().numpy(),
                          ev_cut, i)
        out["levels"][str(lv)] = {
            "mcd_db": float(np.mean(mcds)),
            "final_loss": float(m["metrics"]["loss"]) if m else None,
            "steps": steps, "train_seconds": train_s}
    return out
