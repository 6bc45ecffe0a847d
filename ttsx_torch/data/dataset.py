"""Wav-tree dataset (``ttsx/data/dataset.py``): numpy, scipy and the
native wav decoder.

Discovers ``<root>/<speaker>/<domain>/<style>/*.wav`` with a parallel
transcript tree and returns per-item dicts: wav, text ids, a sentence
embedding and the speaker / domain / style ids. Mel, f0 and energy are
computed per batch by the collator. Also the speaker encoder's
``path<TAB>speaker`` manifests (``load_file_list``) and its
speaker-balanced batch sampler.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ttsx_torch.core.config import AudioConfig


def read_wav(path: str | Path, target_sr: int | None = None
             ) -> Tuple[np.ndarray, int]:
    """A wav as float32 mono in [-1, 1], linearly resampled to
    ``target_sr``: the native single-pass decoder
    (``ttsx_torch.native``'s ``_ttsx_wavio``) where it builds, as the
    reference prefers its own; an encoding it does not read (or a build
    that failed) goes to scipy's reader, which gives the same samples."""
    from ttsx_torch.native import try_load
    wavio = try_load("_ttsx_wavio")
    if wavio is not None:
        try:
            return wavio.read_wav(str(path), int(target_sr or 0))
        except ValueError:
            pass    # an encoding the decoder does not read: scipy's turn
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if target_sr and sr != target_sr:
        n = int(round(len(data) * target_sr / sr))
        data = np.interp(np.linspace(0, len(data) - 1, n),
                         np.arange(len(data)), data).astype(np.float32)
        sr = target_sr
    return data, sr


def write_wav(path: str | Path, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


class PhonemeFrontend:
    """Character-level tokenizer with a stable vocabulary; ``lexicon`` maps
    words to their spelled-out pronunciation first."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, lexicon: Optional[Dict[str, str]] = None):
        chars = " abcdefghijklmnopqrstuvwxyz'.,!?-"
        self.vocab = {c: i + 4 for i, c in enumerate(chars)}
        self.lexicon = lexicon or {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + 4

    def __call__(self, text: str) -> np.ndarray:
        text = text.lower().strip()
        text = " ".join(self.lexicon.get(w, w) for w in text.split())
        ids = ([self.BOS] + [self.vocab.get(c, self.UNK) for c in text]
               + [self.EOS])
        return np.asarray(ids, np.int32)


class TextEncoder:
    """Deterministic sentence embedding: a hashed uni/bigram projection into
    ``dim``, unit norm; ``encode_fn`` substitutes real embeddings."""

    def __init__(self, dim: int = 384, encode_fn=None):
        self.dim = dim
        self.encode_fn = encode_fn

    def __call__(self, text: str) -> np.ndarray:
        if self.encode_fn is not None:
            return np.asarray(self.encode_fn(text), np.float32)
        vec = np.zeros(self.dim, np.float32)
        toks = text.lower().split()
        for n in (1, 2):
            for i in range(len(toks) - n + 1):
                g = " ".join(toks[i:i + n])
                h = int(hashlib.md5(g.encode()).hexdigest(), 16)
                vec[h % self.dim] += 1.0 if n == 1 else 0.5
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec


@dataclass
class TTSDatasetConfig:
    audio_root: str = ""
    transcript_root: Optional[str] = None  # defaults to audio_root
    audio: AudioConfig = field(default_factory=AudioConfig)
    max_frames: Optional[int] = None
    include_speakers: Optional[Sequence[str]] = None
    text_emb_dim: int = 384


class TTSDataset:
    """``<root>/<speaker>/<domain>/<style>/*.wav``, transcripts beside them
    as ``.txt`` (or under ``transcript_root``)."""

    def __init__(self, cfg: TTSDatasetConfig,
                 frontend: Optional[PhonemeFrontend] = None,
                 text_encoder: Optional[TextEncoder] = None):
        self.cfg = cfg
        self.frontend = frontend or PhonemeFrontend()
        self.text_encoder = text_encoder or TextEncoder(cfg.text_emb_dim)
        self.items: List[Dict] = []
        self.spk2id: Dict[str, int] = {}
        self.dom2id: Dict[str, int] = {}
        self.sty2id: Dict[str, int] = {}
        self._discover()

    def _discover(self):
        root = Path(self.cfg.audio_root)
        troot = Path(self.cfg.transcript_root or self.cfg.audio_root)
        include = (set(self.cfg.include_speakers)
                   if self.cfg.include_speakers else None)
        for wav_path in sorted(root.glob("*/*/*/*.wav")):
            style = wav_path.parent.name
            domain = wav_path.parent.parent.name
            speaker = wav_path.parent.parent.parent.name
            if include and speaker not in include:
                continue
            txt_path = (troot / wav_path.relative_to(root)).with_suffix(".txt")
            transcript = (txt_path.read_text().strip()
                          if txt_path.exists() else "")
            for d, key in ((self.spk2id, speaker), (self.dom2id, domain),
                           (self.sty2id, style)):
                if key not in d:
                    d[key] = len(d)
            self.items.append({
                "wav_path": str(wav_path), "transcript": transcript,
                "speaker": speaker, "domain": domain, "style": style})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        it = self.items[idx]
        wav, _ = read_wav(it["wav_path"], self.cfg.audio.sample_rate)
        if self.cfg.max_frames:
            max_samples = self.cfg.max_frames * self.cfg.audio.hop_length
            if len(wav) > max_samples:
                start = np.random.randint(0, len(wav) - max_samples + 1)
                wav = wav[start:start + max_samples]
        text_ids = self.frontend(it["transcript"])
        return {
            "wav": wav,
            "wav_length": len(wav),
            "wav_path": it["wav_path"],
            "text_ids": text_ids,
            "text_length": len(text_ids),
            "text_emb": self.text_encoder(it["transcript"]),
            "transcript": it["transcript"],
            "speaker_id": self.spk2id[it["speaker"]],
            "domain_id": self.dom2id[it["domain"]],
            "style_id": self.sty2id[it["style"]],
        }


def load_file_list(list_path: str | Path) -> List[Tuple[str, str]]:
    """(path, speaker) pairs of a manifest: one ``path<TAB>speaker`` (or
    ``path speaker``) per line; blank lines and ``#`` comments skipped, a
    line without a speaker gives ``"unknown"``."""
    out = []
    for line in Path(list_path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t") if "\t" in line else line.rsplit(" ", 1)
        out.append((parts[0], parts[1] if len(parts) > 1 else "unknown"))
    return out


class SpeakerBalancedSampler:
    """Batches of ``spk_per_batch`` speakers x ``utts_per_spk`` item
    indices, drawn without replacement within a batch from the speakers
    that have enough items."""

    def __init__(self, speaker_ids: Sequence[int], spk_per_batch: int,
                 utts_per_spk: int, seed: int = 0):
        self.by_spk: Dict[int, List[int]] = {}
        for i, s in enumerate(speaker_ids):
            self.by_spk.setdefault(int(s), []).append(i)
        self.spk_per_batch = spk_per_batch
        self.utts_per_spk = utts_per_spk
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        speakers = [s for s, items in self.by_spk.items()
                    if len(items) >= self.utts_per_spk]
        while len(speakers) >= self.spk_per_batch:
            chosen = self.rng.choice(speakers, self.spk_per_batch,
                                     replace=False)
            batch = []
            for s in chosen:
                batch.extend(self.rng.choice(self.by_spk[s],
                                             self.utts_per_spk,
                                             replace=False).tolist())
            yield batch
