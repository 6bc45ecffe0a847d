"""Synthetic trainer batches without audio files (``ttsx/data/synthetic.py``),
same keys as ``collator_to_trainer_batch`` produces. Numpy only."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ttsx_torch.core.config import TTSXConfig


def synthetic_batch(cfg: TTSXConfig, batch: int = 2, frames: int = 16,
                    seed: int = 0, with_wav: bool = True) -> Dict:
    rng = np.random.default_rng(seed)
    hop = int(np.prod(cfg.vocoder.upsample_factors))
    T = frames
    out = {
        "text_emb": rng.normal(size=(batch, T, cfg.acoustic.text_emb_dim)
                               ).astype(np.float32),
        "prosody": rng.normal(size=(batch, T, 18)).astype(np.float32),
        "emotion_probs": np.full((batch, 6), 1 / 6, np.float32),
        "mel": rng.normal(size=(batch, T, 80)).astype(np.float32) * 0.5,
        "speaker": rng.normal(size=(batch, cfg.acoustic.speaker_dim)
                              ).astype(np.float32),
        "style_id": np.zeros(batch, np.int32),
        "frame_mask": np.ones((batch, T), bool),
        "f0": rng.normal(size=(batch, T)).astype(np.float32),
        "energy": rng.normal(size=(batch, T)).astype(np.float32),
        "duration": np.abs(rng.normal(size=(batch, T))).astype(np.float32),
        "pitch": rng.normal(size=(batch, T)).astype(np.float32),
    }
    if with_wav:
        out["wav"] = (rng.normal(size=(batch, T * hop, 1)) * 0.1
                      ).astype(np.float32)
    return out


def synthetic_stream(cfg: TTSXConfig, batch: int = 2, frames: int = 16,
                     n: int = 10, seed: int = 0, start: int = 0
                     ) -> Iterator[Dict]:
    """Batches ``start`` .. ``n - 1`` of the stream, batch i drawn from
    ``seed + i``."""
    for i in range(start, n):
        yield synthetic_batch(cfg, batch, frames, seed=seed + i)
