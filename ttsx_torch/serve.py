"""Fixed-bucket batched synthesis serving (``ttsx/serve.py``).

Requests are padded into a (max_batch, frames) bucket, run through
``TTSPipeline.synthesize(use_sde=False)`` on the device, and trimmed back
to ``len * hop`` samples each; batches above ``max_batch`` are split.
On the card the server states full f32 numerics (no TF32). The reference's
``chain`` and ``mesh`` options have no counterpart here, and bf16 serving
is not ported yet (``bf16=True`` raises).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ttsx_torch.core.device import resolve_device, set_f32_numerics
from ttsx_torch.models.pipeline import TTSPipeline


@dataclass
class SynthesisRequest:
    text_emb: np.ndarray       # [T, D]
    prosody: np.ndarray        # [T, 18]
    emotion_probs: np.ndarray  # [6]
    speaker: np.ndarray        # [Ds]
    style_id: int


class SynthesisServer:
    def __init__(self, pipe: TTSPipeline, device="cuda", max_batch: int = 8,
                 frames: int = 512, bf16: bool = False,
                 loudness_peak: Optional[float] = None,
                 scale_stats: Optional[np.ndarray] = None):
        if bf16:
            raise NotImplementedError("bf16 serving is not ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.cfg = pipe.cfg
        self.pipe = pipe.to(self.device)
        # a scale_cond generator needs [mean || std] mel stats; a text->wav
        # request has no target utterance, so the train-corpus mean vector
        # (the export meta's `mel_scale_mean`) is required
        if self.cfg.vocoder.scale_cond:
            if scale_stats is None:
                raise ValueError(
                    "cfg.vocoder.scale_cond is on: pass scale_stats "
                    "([2*channels] train-corpus mean mel [mean||std], e.g. "
                    "the vocoder export's `mel_scale_mean` meta)")
            scale_stats = torch.as_tensor(
                np.asarray(scale_stats, np.float32).reshape(-1),
                device=self.device)
        self.scale_stats = scale_stats
        self.max_batch = max_batch
        self.frames = frames
        self.loudness_peak = loudness_peak

    def pad_batch(self, reqs: Sequence[SynthesisRequest]):
        """Numpy (text, prosody, emotion, speaker, style_id, lens) of the
        first ``max_batch`` requests, zero-padded to ``frames``."""
        B, T = self.max_batch, self.frames
        ac = self.cfg.acoustic
        text = np.zeros((B, T, ac.text_emb_dim), np.float32)
        pros = np.zeros((B, T, ac.cond_dim), np.float32)
        emo = np.full((B, ac.emotion_dim), 1 / ac.emotion_dim, np.float32)
        spk = np.zeros((B, ac.speaker_dim), np.float32)
        sid = np.zeros((B,), np.int64)
        lens = np.zeros(B, np.int64)
        for i, r in enumerate(reqs[:B]):
            t = min(len(r.text_emb), T)
            text[i, :t] = r.text_emb[:t]
            pros[i, :t] = r.prosody[:t]
            emo[i] = r.emotion_probs
            spk[i] = r.speaker
            sid[i] = r.style_id
            lens[i] = t
        return text, pros, emo, spk, sid, lens

    def run(self, text, pros, emo, spk, sid) -> torch.Tensor:
        """The padded batch through the pipeline -> wav [B, T*hop, 1]."""
        scale = None
        if self.scale_stats is not None:
            scale = self.scale_stats.expand(text.shape[0], -1)
        return self.pipe.synthesize(text, pros, emo, spk, sid,
                                    scale=scale).wav

    def serve_batch(self, reqs: Sequence[SynthesisRequest]) -> List[np.ndarray]:
        if len(reqs) > self.max_batch:
            out: List[np.ndarray] = []
            for i in range(0, len(reqs), self.max_batch):
                out.extend(self.serve_batch(reqs[i:i + self.max_batch]))
            return out
        *arrays, lens = self.pad_batch(reqs)
        wav = self.run(*(torch.as_tensor(a, device=self.device)
                         for a in arrays)).cpu().numpy()
        hop = self.cfg.vocoder.hop_length
        outs = [wav[i, :int(lens[i]) * hop, 0] for i in range(len(reqs))]
        if self.loudness_peak is not None:
            outs = [w * (self.loudness_peak / max(float(np.abs(w).max()), 1e-8))
                    for w in outs]
        return outs
