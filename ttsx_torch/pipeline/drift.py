"""Prosody-drift detection stage.

Re-designs modules/drift/drift.py:20-179: rolling-std adaptive thresholds
(window 50), buffer-zone merge, polarity grouping, whiplash filter,
Savitzky-Golay smoothing, per-event confidence; writes drift_vector.json
(deltas, slices, slice_boundaries, boundaries) and drift_log.json.

A copy of ``ttsx/pipeline/drift.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json


def savgol_smooth(x: np.ndarray, window: int = 7, order: int = 2) -> np.ndarray:
    """Savitzky-Golay smoothing via local least-squares (scipy-free)."""
    if len(x) < window:
        return x.copy()
    half = window // 2
    # precompute projection row for the window center
    a = np.vander(np.arange(-half, half + 1), order + 1, increasing=True)
    proj = np.linalg.pinv(a)[0]  # coefficients for the constant term
    pad = np.pad(x, (half, half), mode="edge")
    out = np.convolve(pad, proj[::-1], mode="valid")
    return out.astype(x.dtype)


def detect_drift(deltas: np.ndarray, window: int = 50,
                 k_sigma: float = 2.0, buffer_frames: int = 3,
                 whiplash_gap: int = 2) -> Dict:
    """Adaptive-threshold drift events over a prosody-delta series.

    Returns events [{start, end, polarity, confidence}] and boundaries.
    """
    n = len(deltas)
    if n == 0:
        return {"events": [], "boundaries": []}
    sm = savgol_smooth(deltas.astype(np.float64))
    # rolling std threshold
    thresh = np.empty(n)
    for i in range(n):
        lo = max(0, i - window)
        seg = sm[lo:i + 1]
        thresh[i] = k_sigma * (seg.std() + 1e-6)
    hits = np.abs(sm) > thresh
    polarity = np.sign(sm)

    # group consecutive hits, merging across small buffer-zone gaps with
    # the same polarity (drift.py buffer-zone merge + polarity grouping)
    events = []
    i = 0
    while i < n:
        if not hits[i]:
            i += 1
            continue
        start, pol = i, polarity[i]
        j = i
        gap = 0
        while j + 1 < n and gap <= buffer_frames:
            j += 1
            if hits[j] and polarity[j] == pol:
                gap = 0
            else:
                gap += 1
        end = j - gap
        mag = float(np.abs(sm[start:end + 1]).mean())
        conf = float(np.clip(mag / (thresh[start:end + 1].mean() + 1e-6) - 1.0,
                             0.0, 1.0))
        events.append({"start": int(start), "end": int(end),
                       "polarity": int(pol), "confidence": round(conf, 3)})
        i = end + 1

    # whiplash filter: drop opposite-polarity events separated by tiny gaps
    filtered = []
    for ev in events:
        if (filtered and filtered[-1]["polarity"] == -ev["polarity"]
                and ev["start"] - filtered[-1]["end"] <= whiplash_gap
                and ev["confidence"] < filtered[-1]["confidence"]):
            continue
        filtered.append(ev)

    boundaries = sorted({ev["start"] for ev in filtered}
                        | {ev["end"] + 1 for ev in filtered})
    return {"events": filtered, "boundaries": boundaries}


def slices_from_boundaries(boundaries: List[int], total: int,
                           min_len: int = 1) -> List[List[int]]:
    pts = [0] + [b for b in boundaries if 0 < b < total] + [total]
    out = []
    for a, b in zip(pts[:-1], pts[1:]):
        if b - a >= min_len:
            out.append([a, b])
    return out


class DriftStage(Stage):
    """Reads prosody_trend.json per speaker, writes drift_vector.json +
    drift_log.json."""
    name = "drift"

    def __init__(self, window: int = 50, k_sigma: float = 2.0):
        self.window = window
        self.k_sigma = k_sigma

    def run(self, context: Dict) -> Dict:
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            trend = read_json(d / "prosody_trend.json", {})
            f0 = np.asarray(trend.get("f0", []), np.float64)
            energy = np.asarray(trend.get("energy", []), np.float64)
            if len(f0) == 0:
                continue
            deltas = np.diff(f0, prepend=f0[:1]) + 0.5 * np.diff(
                energy, prepend=energy[:1] if len(energy) else 0.0)
            det = detect_drift(deltas, self.window, self.k_sigma)
            slices = slices_from_boundaries(det["boundaries"], len(deltas))
            vec = {
                "deltas": deltas.round(5).tolist(),
                "slices": slices,
                "slice_boundaries": det["boundaries"],
                "boundaries": det["boundaries"],
                "events": det["events"],
            }
            write_json_atomic(d / "drift_vector.json", vec)
            write_json_atomic(d / "drift_log.json", {
                "n_events": len(det["events"]),
                "mean_abs_delta": float(np.abs(deltas).mean()),
            })
            results[spk] = {"n_events": len(det["events"]),
                            "n_slices": len(slices)}
        return {"speakers": results}
