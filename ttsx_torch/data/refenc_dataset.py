"""Speaker-encoder and prosody datasets (``ttsx/data/refenc_dataset.py``).

``RefEncDataset``: (path, speaker) items -> (mel [T, n_mels], label) or
(wav, label). In training each item is cropped at random to 2-4 s, then
takes the augments in the reference's order (noise with probability
0.5, reverb 0.3, speed 0.3) and, after the mel, SpecAugment (one
frequency mask of up to 15 bins, one time mask of up to 35 frames), all
drawn from the dataset's seeded numpy generator. ``ProsodyManifestDataset``
reads a JSON manifest of mels or wavs with speaker, emotion, VADER and
prosody labels. The default ``mel_fn`` of both is the plain
``mel_spectrogram`` on ``device``, as in the reference (not the
collator's kernel).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.data.collate import (add_noise, add_reverb, mixup,
                                     spec_augment, speed_perturb)
from ttsx_torch.data.dataset import read_wav
from ttsx_torch.dsp.stft import mel_spectrogram


def plain_mel_fn(audio: AudioConfig, device="cuda"):
    """wav [N] (numpy) -> log-mel [T, n_mels] (numpy) through
    ``mel_spectrogram`` on ``device``."""
    dev = resolve_device(device)

    def mel_fn(wav: np.ndarray) -> np.ndarray:
        w = torch.as_tensor(np.asarray(wav, np.float32)[None], device=dev)
        return mel_spectrogram(w, audio)[0].cpu().numpy()
    return mel_fn


class RefEncDataset:
    def __init__(self, file_list: Sequence[Tuple[str, str]],
                 audio: Optional[AudioConfig] = None, train: bool = True,
                 return_mel: bool = True,
                 crop_seconds: Tuple[float, float] = (2.0, 4.0),
                 seed: int = 0, mel_fn=None, device="cuda"):
        self.items = list(file_list)
        self.audio = audio or AudioConfig()
        self.train = train
        self.return_mel = return_mel
        self.crop_seconds = crop_seconds
        self.rng = np.random.default_rng(seed)
        self.spk2id = {s: i for i, s in
                       enumerate(sorted({spk for _, spk in self.items}))}
        self.mel_fn = mel_fn or plain_mel_fn(self.audio, device)

    def __len__(self):
        return len(self.items)

    @property
    def speaker_ids(self) -> List[int]:
        return [self.spk2id[spk] for _, spk in self.items]

    def __getitem__(self, idx: int):
        path, spk = self.items[idx]
        wav, _ = read_wav(path, self.audio.sample_rate)
        if self.train:
            lo, hi = self.crop_seconds
            crop = int(self.rng.uniform(lo, hi) * self.audio.sample_rate)
            if len(wav) > crop:
                start = self.rng.integers(0, len(wav) - crop + 1)
                wav = wav[start:start + crop]
            if self.rng.random() < 0.5:
                wav = add_noise(wav, self.rng)
            if self.rng.random() < 0.3:
                wav = add_reverb(wav, self.rng)
            if self.rng.random() < 0.3:
                wav = speed_perturb(wav, self.rng)
        label = self.spk2id[spk]
        if not self.return_mel:
            return wav, label
        mel = self.mel_fn(wav)
        if self.train:
            mel = spec_augment(mel[None], self.rng, freq_mask=15,
                               time_mask=35)[0]
        return mel.astype(np.float32), label

    def mixup_batch(self, mels: np.ndarray, labels: np.ndarray,
                    alpha: float = 0.4):
        """(mixed mel, labels, permuted labels, lambda) from the dataset's
        generator."""
        return mixup(mels, labels, self.rng, alpha)


class ProsodyManifestDataset:
    """``{"items": [{"mel_path" | "wav_path", "speaker", "emotions": [6],
    "vader": [4], "prosody": [18]}]}`` -> (mel, (speaker, emotions, vader,
    prosody))."""

    def __init__(self, manifest_path: str | Path,
                 audio: Optional[AudioConfig] = None, mel_fn=None,
                 device="cuda"):
        self.items = json.loads(Path(manifest_path).read_text())["items"]
        self.audio = audio or AudioConfig()
        self.mel_fn = mel_fn or plain_mel_fn(self.audio, device)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        it = self.items[idx]
        if "mel_path" in it:
            mel = np.load(it["mel_path"]).astype(np.float32)
        else:
            wav, _ = read_wav(it["wav_path"], self.audio.sample_rate)
            mel = self.mel_fn(wav)
        meta = (it.get("speaker", "unknown"),
                np.asarray(it.get("emotions", [0.0] * 6), np.float32),
                np.asarray(it.get("vader", [0.0] * 4), np.float32),
                np.asarray(it.get("prosody", [0.0] * 18), np.float32))
        return mel, meta
