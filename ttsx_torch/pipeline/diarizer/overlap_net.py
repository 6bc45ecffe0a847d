"""Learned overlap screen for the diarizer
(``ttsx/pipeline/diarizer/overlap_net.py``).

A small conv stack over per-window z-scored log-mel (z-scoring removes
the loudness shortcut: overlapped speech is louder), trained on
synthetic two-speaker mixtures of a corpus. ``OverlapNet`` is flax's
``Conv(32, 3) -> relu -> max_pool(2, stride 2, VALID) -> Conv(32, 3) ->
relu -> mean over time -> Dense(1)`` on [B, W, M], channels last, with
SAME convolutions; its children carry flax's names (``Conv_0``,
``Conv_1``, ``Dense_0``), so ``ttsx_torch.weights`` maps its state dict
to and from the reference's parameter tree.

``train_overlap_net`` trains it on ``device`` with Adam (lr 3e-3, eps
1e-8: optax.adam's defaults) on the mean sigmoid cross-entropy; the
init is flax's default drawn from ``torch.Generator().manual_seed(seed)``
unless ``init`` (a flax variables tree) is given. ``OverlapScreen`` is
the ``detect_overlaps(screen=...)`` hook: a wav window -> P(overlap).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.nn.conv import Conv1d
from ttsx_torch.nn.layers import Dense

WINDOW_FRAMES = 32  # ~0.37 s at hop 256 / sr 22050 — junction-sized


def _znorm(mel: np.ndarray) -> np.ndarray:
    m = mel.mean(axis=(-2, -1), keepdims=True)
    s = mel.std(axis=(-2, -1), keepdims=True) + 1e-5
    return ((mel - m) / s).astype(np.float32)


class _Conv(Conv1d):
    """A flax ``nn.Conv`` at the top of the tree (no inner ``Conv_0``)."""
    flax_inner = None


class OverlapNet(nn.Module):
    """Tiny conv classifier over [B, W, M] z-scored log-mel windows ->
    logits [B]."""

    def __init__(self, hidden: int = 32, n_mels: int = 80):
        super().__init__()
        self.Conv_0 = _Conv(n_mels, hidden, 3)
        self.Conv_1 = _Conv(hidden, hidden, 3)
        self.Dense_0 = Dense(hidden, 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Conv_0(mel))
        x = F.max_pool1d(x.transpose(1, 2), 2, 2).transpose(1, 2)
        x = torch.relu(self.Conv_1(x))
        return self.Dense_0(x.mean(dim=1))[..., 0]


def init_overlap_net(audio: AudioConfig, seed: int = 0,
                     init: Optional[Mapping] = None, device="cuda"
                     ) -> OverlapNet:
    """The OverlapNet ``train_overlap_net`` starts from, on ``device``:
    flax's initializers drawn from ``torch.Generator().manual_seed(seed)``
    (on the CPU, so the same on every device), or the flax tree ``init``."""
    net = OverlapNet(n_mels=audio.n_mels)
    if init is None:
        from ttsx_torch.nn.init import fresh_init_
        fresh_init_(net, torch.Generator().manual_seed(seed))
    else:
        from ttsx_torch.weights import load_flax
        load_flax(net, init)
    return net.to(resolve_device(device))


def make_overlap_windows(corpus, audio: AudioConfig, n: int,
                         seed: int = 0, device="cuda"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """n positive (two-speaker mixture) + n negative (single-speaker)
    log-mel windows, random per-window gain on both classes; the mel on
    ``device``, returned as numpy."""
    from ttsx_torch.dsp.stft import mel_spectrogram

    rng = np.random.default_rng(seed)
    hop = audio.hop_length
    W = WINDOW_FRAMES
    wavs, labels = [], []
    for i in range(2 * n):
        pos = i < n
        a = int(rng.integers(0, corpus.n_speakers))
        wav = corpus.utterance(a, W, rng).wav[:W * hop]
        if pos:
            b = int(rng.choice([s for s in range(corpus.n_speakers)
                                if s != a]))
            other = corpus.utterance(b, W, rng).wav[:W * hop]
            # 0..6 dB signal-to-interference ratio
            g = 10.0 ** (-rng.uniform(0.0, 6.0) / 20.0)
            wav = wav + g * other
        wavs.append(wav * rng.uniform(0.3, 1.0))
        labels.append(float(pos))
    x = torch.as_tensor(np.stack(wavs).astype(np.float32),
                        device=resolve_device(device))
    with torch.no_grad():
        mel = mel_spectrogram(x, audio).cpu().numpy()
    return _znorm(mel), np.asarray(labels, np.float32)


def train_overlap_net(corpus, audio: AudioConfig, steps: int = 300,
                      batch: int = 32, n_train: int = 256,
                      seed: int = 0, device="cuda",
                      init: Optional[Mapping] = None) -> Dict:
    """Train OverlapNet on synthetic mixtures; returns {"params" (the
    state dict), "losses" (one per step), "train_acc", "eval":
    {precision, recall, acc}} (eval on a held-out window set from a
    different seed)."""
    dev = resolve_device(device)
    X, y = make_overlap_windows(corpus, audio, n_train, seed=seed,
                                device=dev)
    Xe, ye = make_overlap_windows(corpus, audio, 128, seed=seed + 1,
                                  device=dev)
    net = init_overlap_net(audio, seed, init, dev)
    opt = torch.optim.Adam(net.parameters(), lr=3e-3, eps=1e-8)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, len(X), batch)
        xb = torch.as_tensor(X[idx], device=dev)
        yb = torch.as_tensor(y[idx], device=dev)
        loss = F.binary_cross_entropy_with_logits(net(xb), yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    def acc_pr(Xs, ys):
        with torch.no_grad():
            p = net(torch.as_tensor(Xs, device=dev)).cpu().numpy() > 0.0
        tp = float(np.sum(p & (ys > 0.5)))
        prec = tp / max(float(p.sum()), 1.0)
        rec = tp / max(float((ys > 0.5).sum()), 1.0)
        return {"precision": prec, "recall": rec,
                "acc": float(np.mean(p == (ys > 0.5)))}

    return {"params": net.state_dict(),
            "losses": ([float(v) for v in torch.stack(losses).cpu()]
                       if losses else []),
            "train_acc": acc_pr(X, y)["acc"], "eval": acc_pr(Xe, ye)}


class OverlapScreen:
    """wav window [N] -> P(overlap); the detect_overlaps(screen=) hook.
    ``params`` is an ``OverlapNet`` state dict (``train_overlap_net``'s
    ``"params"``)."""

    def __init__(self, audio: AudioConfig, params: Mapping, device="cuda"):
        self.audio = audio
        self.device = resolve_device(device)
        self.net = OverlapNet(n_mels=audio.n_mels)
        self.net.load_state_dict(params)
        self.net = self.net.eval().to(self.device)

    def __call__(self, wav: np.ndarray) -> float:
        from ttsx_torch.dsp.stft import mel_spectrogram

        W = WINDOW_FRAMES * self.audio.hop_length
        if len(wav) < W:
            wav = np.pad(wav, (0, W - len(wav)))
        x = torch.as_tensor(wav[None, :W].astype(np.float32),
                            device=self.device)
        with torch.no_grad():
            mel = mel_spectrogram(x, self.audio).cpu().numpy()
            mel = _znorm(mel)[:, :WINDOW_FRAMES]
            logit = self.net(torch.as_tensor(mel, device=self.device))
            return float(torch.sigmoid(logit)[0])
