"""Stage 2, the S4 prosody predictor and the emotion head
(``ttsx/models/prosody.py``).

``ProsodyPredictor``: mel [B, T, n_mels] -> the prosody dict: ``f0``,
``energy`` and ``pitch_var`` per frame [B, T], ``speech_rate`` and
``pause_dur`` per utterance [B, 1], ``mfcc`` [B, n_mfcc]. A Dense to
``cond_dim``, the sinusoidal table of ``n_freq`` rows cropped or
tail-extended to T, ``n_layers`` S4 layers (the configured route: the
predictor's layers are non-causal, so the rFFT convolution), and a
LayerNorm + Dense head per output, the utterance heads on the mean over
the valid frames. ``pack_prosody`` builds the [B, T, 18] conditioning of
the synthesis chain.

``EmotionClassifier``: 23 features -> a Dense to ``hidden`` as one token,
``n_layers`` post-norm transformer layers (flax's
``MultiHeadDotProductAttention`` over the length-1 sequence, a tanh GELU
feed-forward) -> sigmoid probabilities of the six ``EMOTIONS``.
``EmotionWeightLearner`` gates the VADER / prosody blend.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ttsx_torch.core.config import ProsodyConfig
from ttsx_torch.nn.attention import MHSA
from ttsx_torch.nn.embed import extend_to_length, sinusoidal_table
from ttsx_torch.nn.layers import Dense, LayerNorm, gelu
from ttsx_torch.nn.pooling import masked_mean
from ttsx_torch.nn.s4 import S4

PROSODY_DIM = 18  # 5 scalars broadcast over time + 13 MFCCs
EMOTIONS = ("joy", "sadness", "anger", "fear", "surprise", "neutral")
FRAME_HEADS = ("f0", "energy", "pitch_var")
UTTERANCE_HEADS = ("speech_rate", "pause_dur", "mfcc")


class ProsodyPredictor(nn.Module):
    def __init__(self, cfg: ProsodyConfig = ProsodyConfig()):
        super().__init__()
        self.cfg = cfg
        C = cfg.cond_dim
        self.Dense_0 = Dense(cfg.mel_dim, C)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(cfg.n_freq, C)),
            persistent=False)
        for i in range(cfg.n_layers):
            self.add_module(f"s4_{i}", S4(C, cfg.s4))
        outs = {"mfcc": cfg.n_mfcc}
        for head in FRAME_HEADS + UTTERANCE_HEADS:
            self.add_module(f"{head}_ln", LayerNorm(C))
            self.add_module(f"{head}_out", Dense(C, outs.get(head, 1)))

    def _head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_out")(getattr(self, f"{name}_ln")(x))

    def forward(self, mel: torch.Tensor, mask: torch.Tensor | None = None
                ) -> Dict[str, torch.Tensor]:
        h = self.Dense_0(mel) + extend_to_length(self.pe, mel.shape[1])[None]
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"s4_{i}")(h)
        pooled = masked_mean(h, mask)
        out = {k: self._head(k, h)[..., 0] for k in FRAME_HEADS}
        out.update({k: self._head(k, pooled) for k in UTTERANCE_HEADS})
        return out


def pack_prosody(feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The [B, T, 18] conditioning: f0, energy, pitch_var per frame, then
    speech_rate, pause_dur and the MFCCs broadcast over time."""
    B, T = feats["f0"].shape
    per_frame = torch.stack([feats[k] for k in FRAME_HEADS], dim=-1)
    rate = feats["speech_rate"][:, :, None].expand(B, T, 1)
    pause = feats["pause_dur"][:, :, None].expand(B, T, 1)
    mfcc = feats["mfcc"][:, None, :].expand(B, T, feats["mfcc"].shape[-1])
    return torch.cat([per_frame, rate, pause, mfcc], dim=-1)


class MultiHeadDotProductAttention(MHSA):
    """flax's attention module named on its own (its query, key, value
    and out leaves directly under it)."""
    flax_inner = None


class EmotionClassifier(nn.Module):
    def __init__(self, in_dim: int = 23, hidden: int = 64,
                 n_emotions: int = 6, n_layers: int = 2, heads: int = 4):
        super().__init__()
        self.n_layers = n_layers
        self.Dense_0 = Dense(in_dim, hidden)
        for i in range(n_layers):
            self.add_module(f"MultiHeadDotProductAttention_{i}",
                            MultiHeadDotProductAttention(hidden, heads))
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(hidden))
            self.add_module(f"Dense_{2 * i + 1}", Dense(hidden, 2 * hidden))
            self.add_module(f"Dense_{2 * i + 2}", Dense(2 * hidden, hidden))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(hidden))
        self.add_module(f"Dense_{2 * n_layers + 1}",
                        Dense(hidden, n_emotions))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        m = dict(self.named_children())
        h = self.Dense_0(features)[:, None, :]
        for i in range(self.n_layers):
            h = m[f"LayerNorm_{2 * i}"](
                h + m[f"MultiHeadDotProductAttention_{i}"](h))
            f = m[f"Dense_{2 * i + 2}"](gelu(m[f"Dense_{2 * i + 1}"](h)))
            h = m[f"LayerNorm_{2 * i + 1}"](h + f)
        return torch.sigmoid(m[f"Dense_{2 * self.n_layers + 1}"](h[:, 0]))


class EmotionWeightLearner(nn.Module):
    """[B, 4] VADER + [B, 19] prosody -> [B, 1] blend weight."""

    def __init__(self, in_dim: int = 23, hidden: int = 32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden)
        self.Dense_1 = Dense(hidden, 1)

    def forward(self, vader: torch.Tensor, prosody_vec: torch.Tensor
                ) -> torch.Tensor:
        h = torch.relu(self.Dense_0(torch.cat([vader, prosody_vec], dim=-1)))
        return torch.sigmoid(self.Dense_1(h))


def assign_emotion_tags(probs) -> List[Tuple[str, str]]:
    """The (primary, secondary) emotion names of each row, by probability."""
    order = np.argsort(-np.asarray(torch.as_tensor(probs).detach().cpu()),
                       axis=-1)
    return [(EMOTIONS[i[0]], EMOTIONS[i[1]]) for i in order]
