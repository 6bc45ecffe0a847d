"""Acoustic-model evaluation and microbenchmarks
(``ttsx/eval/acoustic_eval.py``): the validation L1, the silhouette of
the emotion inputs against the speaker ids, the emotion-tag accuracy of
an annotations file and the MOS placeholder; forward timers of the
acoustic model and the prosody predictor.

The model holds its own weights, so ``evaluate_acoustic`` takes no
``params``; it runs on the model's device. The reference's
``emotion_probs_fn`` argument, which it does not use, is not carried.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ttsx_torch.eval.benchmarks import time_fn
from ttsx_torch.eval.metrics import silhouette_score

MOS_PLACEHOLDER = 4.0  # a MOS needs human raters


@torch.no_grad()
def evaluate_acoustic(model, batches: Iterable[Dict],
                      annotations_path: Optional[str] = None) -> Dict:
    """{"val_loss": mean over batches of the mean |mel - target|, "mos",
    "silhouette" of the batches' ``emotion_probs`` by ``speaker_id``
    (all 0 where a batch has none), "emotion_accuracy" of
    ``annotations_path``'s items (``predicted == label``) when the file
    exists}. A batch holds ``text_emb``, ``prosody``, ``emotion_probs``,
    ``mel`` and optionally ``speaker`` (the speaker embedding), numpy or
    tensors."""
    device = next(model.parameters()).device

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)
    losses, emo_preds, speaker_ids = [], [], []
    for batch in batches:
        speaker = batch.get("speaker")
        out = model(t(batch["text_emb"]), t(batch["prosody"]),
                    t(batch["emotion_probs"]),
                    speaker=None if speaker is None else t(speaker))
        losses.append(float((out.mel - t(batch["mel"])).abs().mean()))
        emo_preds.append(np.asarray(batch["emotion_probs"]))
        sid = batch.get("speaker_id",
                        np.zeros(np.shape(batch["mel"])[0], np.int64))
        speaker_ids.append(np.asarray(sid))

    result = {
        "val_loss": float(np.mean(losses)) if losses else float("nan"),
        "mos": MOS_PLACEHOLDER,
    }
    if emo_preds:
        result["silhouette"] = silhouette_score(np.concatenate(emo_preds),
                                                np.concatenate(speaker_ids))
    if annotations_path and Path(annotations_path).exists():
        ann = json.loads(Path(annotations_path).read_text())
        correct = total = 0
        for item in ann.get("items", []):
            total += 1
            if item.get("predicted") == item.get("label"):
                correct += 1
        result["emotion_accuracy"] = correct / total if total else 0.0
    return result


def microbenchmarks(runs: int = 20, frames: int = 128, device="cuda"
                    ) -> Dict:
    """``time_fn`` of the acoustic model's and the prosody predictor's
    forwards (no gradient) at their default configs, batch 2 x
    ``frames``, fresh inits seeded 0: {"acoustic", "prosody"}."""
    from ttsx_torch.core.config import AcousticConfig, ProsodyConfig
    from ttsx_torch.core.device import resolve_device
    from ttsx_torch.models.acoustic import AcousticModel
    from ttsx_torch.models.prosody import ProsodyPredictor
    from ttsx_torch.nn.init import fresh_init_

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    out: Dict = {}
    ac_cfg = AcousticConfig()
    ac = fresh_init_(AcousticModel(ac_cfg), gen).to(dev).eval()
    text = torch.zeros(2, frames, ac_cfg.text_emb_dim, device=dev)
    pros = torch.zeros(2, frames, ac_cfg.cond_dim, device=dev)
    emo = torch.full((2, ac_cfg.emotion_dim), 1 / ac_cfg.emotion_dim,
                     device=dev)
    pr_cfg = ProsodyConfig()
    pr = fresh_init_(ProsodyPredictor(pr_cfg), gen).to(dev).eval()
    mel = torch.zeros(2, frames, pr_cfg.audio.n_mels, device=dev)
    with torch.inference_mode():
        out["acoustic"] = time_fn(lambda *a: ac(*a).mel, text, pros, emo,
                                  runs=runs)
        out["prosody"] = time_fn(lambda m: pr(m)["f0"], mel, runs=runs)
    return out
