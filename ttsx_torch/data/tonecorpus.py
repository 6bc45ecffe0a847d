"""The synthetic tone corpus the zoo was trained on
(``ttsx/data/tonecorpus.py``; ``zoo.json``: ``ToneCorpus(n_speakers=8)``).

Speakers are a fundamental frequency and a smooth harmonic envelope;
"phonemes" are harmonic amplitude masks with a tremolo rate and a fixed
random embedding; an utterance is a random phoneme sequence synthesized
additively (with an optional pitch contour and noise). Everything is
numpy from the seed, the reference's draws in the reference's order, so
one seed gives the same arrays in both packages. ``features`` runs the
port's DSP frontend (``mel_spectrogram``, ``extract_f0_energy``) on
``device`` and assembles the trainer's batch; ``dialogue`` and
``dialogue_hard`` build multi-speaker streams with their segments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.eval.metrics import log_mel_to_cepstra


def _smooth_random(rng: np.random.Generator, n: int, smooth: int = 3,
                   lo: float = 0.1, hi: float = 1.0) -> np.ndarray:
    """Random positive curve smoothed by a moving average."""
    x = rng.uniform(lo, hi, n + 2 * smooth)
    k = np.ones(2 * smooth + 1) / (2 * smooth + 1)
    return np.convolve(x, k, mode="valid")[:n]


@dataclass
class Utterance:
    wav: np.ndarray          # [N] float32
    phoneme_ids: np.ndarray  # [T_frames] int32, frame-aligned
    speaker: int
    f0_hz: float


class ToneCorpus:
    """Deterministic synthetic corpus: speakers x phonemes -> utterances."""

    N_HARMONICS = 12

    def __init__(self, n_speakers: int = 12, n_phonemes: int = 24,
                 text_dim: int = 256, audio: Optional[AudioConfig] = None,
                 seed: int = 0, n_f0_groups: Optional[int] = None,
                 noise_db: Optional[float] = None,
                 intonation: float = 0.0):
        self.audio = audio or AudioConfig()
        self.n_speakers = n_speakers
        self.n_phonemes = n_phonemes
        self.noise_db = noise_db
        # fractional per-segment pitch excursion (0 = constant-pitch
        # utterances). Constant pitch is what the EER/MCD/DER experiments
        # recorded on; the prosody-predictor experiment needs real
        # within-utterance f0 contours or the z-scored frame target is
        # pure tracker jitter, so it opts in with e.g. intonation=0.2.
        self.intonation = float(intonation)
        rng = np.random.default_rng(seed)
        H = self.N_HARMONICS
        # speaker timbre: F0 + harmonic envelope. With n_f0_groups set,
        # several speakers SHARE each F0 value, so identity is only
        # recoverable from the learned envelope (a trivial pitch detector
        # can't separate them) — this makes the EER experiment a real test
        # of the encoder rather than of the f0 tracker.
        if n_f0_groups:
            groups = rng.uniform(90.0, 280.0, n_f0_groups)
            self.spk_f0 = groups[np.arange(n_speakers) % n_f0_groups]
        else:
            self.spk_f0 = rng.uniform(90.0, 280.0, n_speakers)
        self.spk_env = np.stack(
            [_smooth_random(rng, H, lo=0.05, hi=1.0) for _ in
             range(n_speakers)])                        # [S, H]
        self.spk_env /= self.spk_env.max(axis=1, keepdims=True)
        # phoneme "articulation": harmonic amplitude mask + AM rate
        self.pho_mask = np.stack(
            [_smooth_random(rng, H, lo=0.1, hi=1.0) for _ in
             range(n_phonemes)])                        # [P, H]
        self.pho_am = rng.uniform(1.5, 7.0, n_phonemes)  # tremolo Hz
        # fixed random phoneme embeddings (the corpus's "text encoder")
        emb = rng.normal(size=(n_phonemes, text_dim)).astype(np.float32)
        self.pho_emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)

    # -- synthesis ---------------------------------------------------------
    def utterance(self, speaker: int, frames: int,
                  rng: np.random.Generator) -> Utterance:
        """Additively synthesize one utterance of exactly `frames` mel
        frames (wav length = frames * hop)."""
        au = self.audio
        hop, sr = au.hop_length, au.sample_rate
        H = self.N_HARMONICS
        # frame-aligned phoneme sequence with 6-14 frame segments
        ids = np.empty(frames, np.int32)
        t0 = 0
        while t0 < frames:
            dur = int(rng.integers(6, 15))
            ids[t0:t0 + dur] = rng.integers(0, self.n_phonemes)
            t0 += dur
        n = frames * hop
        t = np.arange(n) / sr
        f0 = float(self.spk_f0[speaker])
        # per-sample harmonic amplitudes from the frame-aligned phoneme mask
        frame_of = np.minimum(np.arange(n) // hop, frames - 1)
        amp = (self.spk_env[speaker][None, :]
               * self.pho_mask[ids[frame_of]])          # [n, H]
        am = 1.0 + 0.3 * np.sin(
            2 * np.pi * self.pho_am[ids[frame_of]] * t)  # tremolo
        phase = rng.uniform(0, 2 * np.pi, H)
        if self.intonation > 0.0:
            # smooth frame-rate pitch contour (glides on the phoneme-
            # segment timescale) -> per-sample instantaneous f0; harmonics
            # stay phase-continuous via phase integration
            w = 9
            raw = rng.uniform(-self.intonation, self.intonation,
                              frames + w - 1)
            off = np.convolve(raw, np.ones(w) / w, mode="valid")  # [frames]
            f0_t = f0 * (1.0 + off[frame_of])            # [n]
            phi = 2 * np.pi * np.cumsum(f0_t) / sr       # [n]
        else:
            phi = 2 * np.pi * f0 * t
        wav = np.zeros(n)
        for h in range(H):
            wav += amp[:, h] * np.sin((h + 1) * phi + phase[h])
        wav *= am
        wav = 0.3 * wav / (np.abs(wav).max() + 1e-8)
        if self.noise_db is not None:
            snr = 10.0 ** (self.noise_db / 20.0)
            wav = wav + rng.normal(size=n) * (np.std(wav) / snr)
        return Utterance(wav.astype(np.float32), ids, speaker, f0)

    def utterances(self, n_per_speaker: int, frames: int, seed: int = 0,
                   speakers: Optional[Sequence[int]] = None
                   ) -> List[Utterance]:
        rng = np.random.default_rng(seed)
        out = []
        for s in (speakers if speakers is not None
                  else range(self.n_speakers)):
            for _ in range(n_per_speaker):
                out.append(self.utterance(int(s), frames, rng))
        return out

    # -- model-contract batches ---------------------------------------------
    def features(self, utts: Sequence[Utterance], device="cuda"
                 ) -> Dict[str, np.ndarray]:
        """Run the DSP frontend on ``device`` over a same-length utterance
        list and assemble the trainer's batch (mel, f0, energy, text_emb,
        18-d prosody, ids, masks), numpy."""
        from ttsx_torch.dsp.features import extract_f0_energy
        from ttsx_torch.dsp.stft import mel_spectrogram

        dev = resolve_device(device)
        wav = np.stack([u.wav for u in utts])           # [B, N]
        w = torch.as_tensor(wav, device=dev)
        mel = mel_spectrogram(w, self.audio).cpu().numpy()
        f0, energy = (a.cpu().numpy()
                      for a in extract_f0_energy(w, self.audio)[:2])
        # frontend framing can emit one extra frame vs the frame-aligned
        # phoneme grid; align everything to the shorter
        T = min(f0.shape[1], min(len(u.phoneme_ids) for u in utts))
        B = f0.shape[0]
        mel, f0, energy = mel[:, :T], f0[:, :T], energy[:, :T]
        ids = np.stack([u.phoneme_ids[:T] for u in utts])
        text_emb = self.pho_emb[ids]                    # [B, T, D]

        # 18-d prosody: z-scored f0/energy/pitch-var + rate/pause + 13 MFCC
        def z(x):
            return ((x - x.mean(axis=1, keepdims=True))
                    / (x.std(axis=1, keepdims=True) + 1e-6))
        pitch_var = np.abs(np.diff(f0, axis=1, prepend=f0[:, :1]))
        mfcc = log_mel_to_cepstra(
            mel.reshape(-1, mel.shape[-1])).reshape(B, T, 13).mean(axis=1)
        prosody = np.concatenate([
            z(f0)[..., None], z(energy)[..., None], z(pitch_var)[..., None],
            np.zeros((B, T, 2)),                         # rate / pause
            np.broadcast_to(mfcc[:, None, :], (B, T, 13)),
        ], axis=-1).astype(np.float32)

        return {
            "wav": wav[..., None].astype(np.float32),
            "mel": mel.astype(np.float32),
            "f0": f0.astype(np.float32),
            "energy": energy.astype(np.float32),
            "text_emb": text_emb.astype(np.float32),
            "prosody": prosody,
            "speaker_id": np.asarray([u.speaker for u in utts], np.int32),
            "style_id": np.zeros(len(utts), np.int32),
            "emotion_probs": np.full((len(utts), 6), 1 / 6, np.float32),
            "frame_mask": np.ones((B, T), bool),
        }

    # -- diarization stream ---------------------------------------------------
    def dialogue(self, speakers: Sequence[int], n_turns: int,
                 turn_frames: Tuple[int, int] = (80, 160),
                 gap_s: float = 0.35, seed: int = 0
                 ) -> Tuple[np.ndarray, List[Tuple[float, float, str]]]:
        """Alternating-speaker stream + RTTM-style ground-truth segments."""
        rng = np.random.default_rng(seed)
        au = self.audio
        sr, hop = au.sample_rate, au.hop_length
        gap = np.zeros(int(gap_s * sr), np.float32)
        pieces, segs = [], []
        cursor = 0.0
        for i in range(n_turns):
            spk = int(speakers[i % len(speakers)])
            frames = int(rng.integers(*turn_frames))
            utt = self.utterance(spk, frames, rng)
            dur = len(utt.wav) / sr
            segs.append((cursor, cursor + dur, f"spk{spk}"))
            pieces.extend([utt.wav, gap])
            cursor += dur + gap_s
        return np.concatenate(pieces), segs

    def dialogue_hard(self, speakers: Sequence[int], n_turns: int,
                      turn_frames: Tuple[int, int] = (80, 160),
                      gap_s: Tuple[float, float] = (0.2, 0.6),
                      overlap_prob: float = 0.3,
                      overlap_s: Tuple[float, float] = (0.15, 0.5),
                      noise_db: Optional[float] = None, seed: int = 0):
        """Hard diarization stream: random (non-repeating) speaker order,
        variable gaps, OVERLAPPED turn onsets with probability
        `overlap_prob`, and optional additive noise at `noise_db` SNR.

        Returns (wav, segs, overlap_regions): `segs` are the true
        per-turn intervals (they genuinely overlap), `overlap_regions`
        the [(start_s, end_s)] where two speakers are simultaneous —
        ground truth for the overlap-screen precision/recall readout.
        Reference analog: hyper_diarizer/overlap.py detects exactly these
        regions; the easy `dialogue` stream has none, which is why
        round-2 trained-vs-untrained DER could not separate."""
        rng = np.random.default_rng(seed)
        sr = self.audio.sample_rate
        turns = []          # (start_sample, wav, spk)
        cursor = 0
        prev_spk = None
        for _ in range(n_turns):
            spk = int(rng.choice([s for s in speakers if s != prev_spk]))
            prev_spk = spk
            utt = self.utterance(spk, int(rng.integers(*turn_frames)), rng)
            if turns and rng.random() < overlap_prob:
                start = cursor - int(rng.uniform(*overlap_s) * sr)
            else:
                start = cursor + int(rng.uniform(*gap_s) * sr)
            start = max(start, 0)
            turns.append((start, utt.wav, spk))
            cursor = start + len(utt.wav)
        wav = np.zeros(cursor, np.float32)
        segs, ivals = [], []
        for start, w, spk in turns:
            wav[start:start + len(w)] += w
            s, e = start / sr, (start + len(w)) / sr
            segs.append((s, e, f"spk{spk}"))
            ivals.append((s, e))
        overlap_regions = [(max(s0, s1), min(e0, e1))
                           for (s0, e0), (s1, e1) in zip(ivals, ivals[1:])
                           if min(e0, e1) > max(s0, s1)]
        peak = np.abs(wav).max() + 1e-8
        if peak > 1.0:
            wav /= peak
        if noise_db is not None:
            snr = 10.0 ** (noise_db / 20.0)
            wav = wav + rng.normal(size=len(wav)).astype(np.float32) \
                * (np.std(wav) / snr)
        return wav.astype(np.float32), segs, overlap_regions
