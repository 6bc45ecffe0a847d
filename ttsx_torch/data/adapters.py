"""Collated batch -> the trainer's batch (``ttsx/data/adapters.py``):
the [B, T, 18] prosody from f0 / energy, the sentence embedding broadcast
over frames, speaker and emotion conditioning. Numpy only."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ttsx_torch.core.config import TTSXConfig


def collator_to_trainer_batch(
    batch: Dict, cfg: TTSXConfig,
    prosody_fn: Optional[Callable] = None,
    speaker_fn: Optional[Callable] = None,
    emotion_fn: Optional[Callable] = None,
    keep_wav: bool = True,
) -> Dict:
    """prosody_fn(mel [B,T,F]) -> [B,T,18] (default: voiced-frame f0
    z-scores, energy, zeros); speaker_fn(batch) -> [B, speaker_dim]
    (default zeros); emotion_fn(batch) -> [B, 6] (default uniform)."""
    mel = np.asarray(batch["mel"], np.float32)
    B, T, _ = mel.shape

    if prosody_fn is not None:
        prosody = np.asarray(prosody_fn(mel), np.float32)
    else:
        f0 = np.asarray(batch.get("f0", np.zeros((B, T))), np.float32)
        energy = np.asarray(batch.get("energy", np.zeros((B, T))),
                            np.float32)
        vm = (f0 > 0).astype(np.float32)
        denom = np.maximum(vm.sum(1, keepdims=True), 1.0)
        mean = (f0 * vm).sum(1, keepdims=True) / denom
        std = np.sqrt(((f0 - mean) ** 2 * vm).sum(1, keepdims=True)
                      / denom) + 1e-3
        f0z = np.where(vm > 0, (f0 - mean) / std, 0.0)
        prosody = np.concatenate(
            [f0z[..., None], energy[..., None],
             np.zeros((B, T, 16), np.float32)], axis=-1)
    prosody = prosody[:, :T, :]

    text_emb = np.asarray(batch["text_emb"], np.float32)
    if text_emb.ndim == 2:  # [B, D] sentence embedding -> broadcast over T
        text_emb = np.repeat(text_emb[:, None, :], T, axis=1)

    speaker = (np.asarray(speaker_fn(batch), np.float32)
               if speaker_fn is not None
               else np.zeros((B, cfg.acoustic.speaker_dim), np.float32))
    emotion = (np.asarray(emotion_fn(batch), np.float32)
               if emotion_fn is not None
               else np.full((B, 6), 1.0 / 6.0, np.float32))

    out = {
        "mel": mel,
        "prosody": prosody,
        "text_emb": text_emb,
        "speaker": speaker,
        "emotion_probs": emotion,
        "style_id": np.asarray(batch.get("style_id", np.zeros(B)), np.int32),
        "frame_mask": np.asarray(batch.get("frame_mask",
                                           np.ones((B, T), bool))),
    }
    if keep_wav and "wav" in batch:
        out["wav"] = np.asarray(batch["wav"], np.float32)
        if out["wav"].ndim == 2:
            out["wav"] = out["wav"][..., None]
    for k in ("f0", "energy", "duration", "pitch"):
        if k in batch:
            out[k] = np.asarray(batch[k], np.float32)
    return out
