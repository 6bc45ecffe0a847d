"""Streaming synthesis: fixed-size chunks with overlap cross-fade
(``ttsx/streaming.py``).

A host loop over fixed [B, chunk, .] windows of an utterance of any
length through the pipeline's ``synthesize``, so every chunk has the
same shapes. Chunk k starts at ``min(k * (chunk - overlap), T - chunk)``
(the last chunk ends at T; a T shorter than a chunk is zero-padded), each
chunk's waveform is weighted by a linear ramp over the ``overlap * hop``
samples of each interior seam, and the sum is divided by the summed
weights: the reference's bounds, ramps and normalisation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ttsx_torch.core.device import resolve_device, set_f32_numerics
from ttsx_torch.models.pipeline import TTSPipeline


class StreamingSynthesizer:
    def __init__(self, pipe: TTSPipeline, chunk_frames: int = 256,
                 overlap_frames: int = 16, device="cuda"):
        if not 0 <= overlap_frames < chunk_frames:
            raise ValueError(f"overlap_frames {overlap_frames} must be in "
                             f"[0, chunk_frames {chunk_frames})")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.pipe = pipe.to(self.device)
        self.cfg = pipe.cfg
        self.chunk = chunk_frames
        self.overlap = overlap_frames
        self.hop = math.prod(self.cfg.vocoder.upsample_factors)

    def chunks(self, T: int):
        """The (lo, hi) frame bounds of the chunks of a T-frame input."""
        step = self.chunk - self.overlap
        n = max(1, -(-max(T - self.overlap, 1) // step))
        return [(lo, lo + self.chunk)
                for lo in (min(k * step, max(T - self.chunk, 0))
                           for k in range(n))]

    def synthesize(self, text_emb: np.ndarray, prosody: np.ndarray,
                   emotion_probs: np.ndarray, speaker: np.ndarray,
                   style_id: np.ndarray) -> np.ndarray:
        """text_emb [B, T, D] of any T -> float32 wav [B, T*hop]."""
        B, T, _ = text_emb.shape
        bounds = self.chunks(T)
        wav = np.zeros((B, T * self.hop), np.float32)
        weight = np.zeros(T * self.hop, np.float32)
        ov = self.overlap * self.hop
        ramp = np.linspace(0.0, 1.0, ov, dtype=np.float32)
        dev = self.device
        fixed = (torch.as_tensor(emotion_probs, device=dev),
                 torch.as_tensor(speaker, device=dev),
                 torch.as_tensor(style_id, dtype=torch.long, device=dev))
        for k, (lo, hi) in enumerate(bounds):
            pad = max(hi - T, 0)
            sl = lambda x: torch.as_tensor(np.pad(
                x[:, lo:min(hi, T)],
                ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2)), device=dev)
            w = self.pipe.synthesize(sl(text_emb), sl(prosody), *fixed).wav
            w = w[:, :, 0].float().cpu().numpy()
            a, b = lo * self.hop, min(hi, T) * self.hop
            # cross-fade only at interior seams
            fade = np.ones(b - a, np.float32)
            if ov and k > 0:
                fade[:ov] = ramp
            if ov and k < len(bounds) - 1:
                fade[-ov:] = np.minimum(fade[-ov:], ramp[::-1])
            wav[:, a:b] += w[:, :b - a] * fade
            weight[a:b] += fade
        return wav / np.maximum(weight, 1e-6)[None]
