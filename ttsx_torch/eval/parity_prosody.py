"""Stage-2 parity (``ttsx/eval/parity_prosody.py``): the prosody predictor
trained on mel -> DSP-derived targets, reported on held-out utterances
as the training loss and the Pearson r of predicted against target
per-frame f0 (voiced frames) and energy, trained against random weights.
The reported numbers are those of the best held-out loss (evaluated every
``max(min(500, steps), steps // 8)`` steps and at the end).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ttsx_torch.eval.parity_common import (AUDIO, _normalize_mels,
                                           experiment_device, make_corpus)


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12
    return float((a * b).sum() / denom)


def prosody_parity(steps: int = 4000, frames: int = 128, batch: int = 16,
                   n_speakers: int = 8, utts_train: int = 60,
                   utts_eval: int = 8, seed: int = 0,
                   cond_dim: int = 256, n_layers: int = 4,
                   intonation: float = 0.2,
                   corpus: str = "tone", export_slim: str = "",
                   device="cuda") -> Dict:
    from ttsx_torch.core.config import ProsodyConfig, S4Config
    from ttsx_torch.dsp.features import extract_f0_energy
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    from ttsx_torch.train.slim_export import save_slim

    dev = experiment_device(device)
    # mfcc_weight 0.05 keeps the raw-scale cepstra from owning the shared
    # trunk's gradient; intonation 0.2 gives the corpus f0 contours
    cfg = ProsodyConfig(
        audio=AUDIO, cond_dim=cond_dim, n_layers=n_layers,
        mfcc_weight=0.05,
        s4=S4Config(heads=4, l_max=1024, causal=False, norm_groups=4,
                    dropout=0.1))
    corpus = make_corpus(corpus, n_speakers=n_speakers, audio=AUDIO,
                         seed=seed, intonation=intonation)
    tr = _normalize_mels(corpus.features(
        corpus.utterances(utts_train, frames, seed=seed), device=dev))
    ev = _normalize_mels(corpus.features(
        corpus.utterances(utts_eval, frames, seed=seed + 1), device=dev))

    def targets_of(d):
        wav = torch.as_tensor(d["wav"][..., 0], device=dev)
        return {k: v.cpu().numpy() for k, v in
                ProsodyTrainer.targets_from_wav(wav, cfg, frames).items()}

    tr_tgt, ev_tgt = targets_of(tr), targets_of(ev)
    ev_voiced = extract_f0_energy(torch.as_tensor(ev["wav"][..., 0],
                                                  device=dev), AUDIO)[2]
    ev_voiced = ev_voiced.cpu().numpy()[:, :frames]

    trainer = ProsodyTrainer(cfg, lr=1e-3,
                             warmup=min(100, max(steps // 10, 1)),
                             total=max(steps, 1), device=dev, seed=seed)

    def evaluate() -> Dict:
        loss = float(trainer.val_step(ev["mel"], ev_tgt))
        with torch.no_grad():
            pred = {k: v.cpu().numpy() for k, v in trainer.model(
                torch.as_tensor(ev["mel"], device=dev)).items()}
        f0_r, en_r = [], []
        for i in range(len(ev["mel"])):
            v = ev_voiced[i]
            if v.sum() >= 8:
                f0_r.append(_pearson(pred["f0"][i][v], ev_tgt["f0"][i][v]))
            en_r.append(_pearson(pred["energy"][i], ev_tgt["energy"][i]))
        return {"loss": loss,
                "f0_pearson_voiced": float(np.mean(f0_r)) if f0_r else 0.0,
                "energy_pearson": float(np.mean(en_r))}

    rand = evaluate()
    eval_every = max(min(500, steps), steps // 8)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    last = float("nan")
    best = dict(rand, step=0)
    curve = []
    for step in range(1, steps + 1):
        idx = rng.integers(0, len(tr["mel"]), batch)
        m = trainer.train_step(tr["mel"][idx],
                               {k: v[idx] for k, v in tr_tgt.items()})
        last = float(m["loss"])
        if step % eval_every == 0 or step == steps:
            ev_m = evaluate()
            curve.append({"step": step, **ev_m})
            if ev_m["loss"] < best["loss"]:
                best = dict(ev_m, step=step)
    secs = time.perf_counter() - t0
    if export_slim:
        # the final parameters, and what a loader needs to rebuild them
        save_slim(export_slim, {
            "prosody": trainer.model,
            "_meta": {"cond_dim": cond_dim, "n_layers": n_layers,
                      "steps": steps}})

    trained = curve[-1]
    return {"exp": "prosody", "steps": steps, "train_seconds": secs,
            "energy_domain": "log_rms_z",
            "final_train_loss": last, "eval_utts": int(len(ev["mel"])),
            "val_loss": best["loss"],
            "val_loss_random_weights": rand["loss"],
            "f0_pearson_voiced": best["f0_pearson_voiced"],
            "f0_pearson_voiced_random_weights": rand["f0_pearson_voiced"],
            "energy_pearson": best["energy_pearson"],
            "energy_pearson_random_weights": rand["energy_pearson"],
            "best_val_step": best["step"],
            "val_loss_final": trained["loss"],
            "f0_pearson_voiced_final": trained["f0_pearson_voiced"],
            "energy_pearson_final": trained["energy_pearson"],
            "eval_curve": curve}
