"""Speaker-encoder parity (``ttsx/eval/parity_refenc.py``): a trained
encoder (ArcFace or GE2E) -> all-pairs cosine EER on held-out
utterances, trained against random weights.

The GE2E batches are the reference's (``batch // 4`` speakers, at least
two, with ``batch // speakers`` utterances each, grouped by speaker);
the port's ``ge2e_loss`` reads the groups from the labels, where the
reference's loss takes them from the trainer's configured micro-batch
and misgroups these batches.
"""
from __future__ import annotations

import copy
import time
from typing import Dict

import numpy as np

from ttsx_torch.core.config import RefEncConfig
from ttsx_torch.eval.parity_common import (AUDIO, experiment_device,
                                           make_corpus)


def _specaugment(m: np.ndarray, rng: np.random.Generator,
                 f_max: int = 15, t_max: int = 35) -> np.ndarray:
    """Per-sample frequency and time masking, filled with the sample's
    mean: fresh masks every step keep ArcFace from memorising the fixed
    corpus utterances."""
    m = m.copy()
    B, T, M = m.shape
    fill = m.mean(axis=(1, 2))
    for i in range(B):
        fw = int(rng.integers(0, f_max + 1))
        f0 = int(rng.integers(0, max(M - fw, 1)))
        m[i, :, f0:f0 + fw] = fill[i]
        tw = int(rng.integers(0, t_max + 1))
        t0 = int(rng.integers(0, max(T - tw, 1)))
        m[i, t0:t0 + tw, :] = fill[i]
    return m


def _ge2e_batch(rng, labels: np.ndarray, n_speakers: int, batch: int):
    """Indices of ``max(batch // 4, 2)`` speakers' utterances, ``batch //
    speakers`` each (drawn with replacement), grouped by speaker."""
    spks = rng.choice(n_speakers, size=max(batch // 4, 2), replace=False)
    return np.concatenate([
        rng.choice(np.flatnonzero(labels == s), size=batch // len(spks),
                   replace=True) for s in spks])[:batch]


def refenc_parity(n_speakers: int = 12, utts_train: int = 16,
                  utts_eval: int = 6, frames: int = 128, steps: int = 800,
                  batch: int = 16, seed: int = 0, specaugment: bool = True,
                  corpus: str = "tone", eval_every: int = 0,
                  patience: int = 6, mixup: bool = False,
                  margin_warmup: int = 0, eval_crops: int = 1,
                  train_frames: int = 0, loss: str = "arcface",
                  export_slim: str = "", device="cuda") -> Dict:
    """``eval_every`` > 0 keeps the parameters of the best held-out EER
    (measured every ``eval_every`` steps) and stops after ``patience``
    evaluations without a gain; ``mixup`` adds beta(0.4) pair mixing;
    ``margin_warmup`` ramps the ArcFace margin; ``eval_crops`` > 1 embeds
    each longer eval utterance as that many half-overlapping crops,
    averaged and renormalised; ``train_frames`` > ``frames`` crops a
    fresh window every step; ``export_slim`` writes the best parameters
    as a slim npz."""
    from ttsx_torch.eval.metrics import all_pairs_eer
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.train.slim_export import params_tree, save_slim

    dev = experiment_device(device)
    # shared-F0 speaker groups + noise: identity lies only in the learned
    # harmonic envelope / vocal-tract scale
    corpus = make_corpus(corpus, n_speakers=n_speakers, audio=AUDIO,
                         seed=seed, n_f0_groups=3, noise_db=12.0)

    def features_chunked(us, chunk=256):
        outs = [corpus.features(us[i:i + chunk], device=dev)
                for i in range(0, len(us), chunk)]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    tf = max(train_frames, frames)
    tr = features_chunked(corpus.utterances(utts_train, tf, seed=seed))
    stride = max(frames // 2, 1)
    ef = frames + (eval_crops - 1) * stride
    ev = features_chunked(corpus.utterances(utts_eval, ef, seed=seed + 1))
    cfg = RefEncConfig(audio=AUDIO, num_speakers=n_speakers,
                       warmup_steps=50, total_steps=steps, eval_every=0,
                       arcface_margin_warmup=margin_warmup, loss=loss)
    trainer = RefEncTrainer(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    mels, labels = tr["mel"], tr["speaker_id"]

    def embed_multicrop(chunk):
        """[b, ef, M] -> averaged renormalised [b, D] over eval_crops."""
        acc = sum(trainer.embed(chunk[:, c * stride:c * stride + frames])
                  .cpu().numpy() for c in range(eval_crops)) / eval_crops
        return acc / np.maximum(
            np.linalg.norm(acc, axis=-1, keepdims=True), 1e-8)

    def eer_of():
        embs = [embed_multicrop(ev["mel"][i:i + batch])
                for i in range(0, len(ev["mel"]), batch)]
        return all_pairs_eer(np.concatenate(embs), ev["speaker_id"])

    def crop(mb):
        if tf > frames:  # fresh crop window every step
            offs = rng.integers(0, tf - frames + 1, len(mb))
            mb = np.stack([m[o:o + frames] for m, o in zip(mb, offs)])
        return _specaugment(mb, rng) if specaugment else mb

    eer_random = float(eer_of())
    t0 = time.perf_counter()
    loss_val = float("nan")
    best = {"eer": float("inf"), "step": 0, "params": None}
    curve = []
    stale = 0
    for step in range(steps):
        idx = (_ge2e_batch(rng, labels, n_speakers, batch) if loss == "ge2e"
               else rng.integers(0, len(mels), batch))
        mb = crop(mels[idx])
        if mixup:
            idx2 = rng.integers(0, len(mels), batch)
            mb2 = crop(mels[idx2])
            alpha = rng.beta(0.4, 0.4, size=batch).astype(np.float32)
            m = trainer.train_step_mixup(mb, mb2, labels[idx], labels[idx2],
                                         alpha)
        else:
            m = trainer.train_step(mb, labels[idx])
        loss_val = float(m["loss"])
        if eval_every and (step + 1) % eval_every == 0:
            e = float(eer_of())
            curve.append([step + 1, round(e, 4)])
            if e < best["eer"]:
                best.update(eer=e, step=step + 1, params={
                    k: v.detach().clone()
                    for k, v in trainer.params.state_dict().items()})
                stale = 0
            else:
                stale += 1
                if stale >= patience:
                    break
    train_s = time.perf_counter() - t0
    eer_final = float(eer_of())
    # the reported EER is the best checkpoint's (what a trainer keeps);
    # eer_final keeps the end-of-run value
    eer = min(eer_final, best["eer"])
    if export_slim:
        keep = trainer.params
        if best["params"] is not None and best["eer"] <= eer_final:
            keep = copy.deepcopy(keep)
            keep.load_state_dict(best["params"])
        save_slim(export_slim, {
            "refenc": params_tree(keep),
            "_meta": {"num_speakers": n_speakers, "steps": steps,
                      "eer": eer, "eval_crops": eval_crops}})
    res = {"exp": "refenc", "eer": eer, "eer_random_weights": eer_random,
           "final_loss": loss_val, "steps": steps,
           "train_seconds": train_s, "specaugment": specaugment,
           "loss_type": loss, "eval_crops": eval_crops,
           "train_frames": tf,
           "n_speakers": n_speakers, "eval_utts": len(ev["mel"])}
    if eval_every:
        res.update(eer_final=eer_final, best_step=best["step"],
                   eer_curve=curve, eval_every=eval_every,
                   mixup=mixup, margin_warmup=margin_warmup)
    return res
