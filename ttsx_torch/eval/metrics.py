"""Metrics of ``ttsx/eval/metrics.py``, numpy on the host: the speaker-
verification EER, the mel-cepstral distortion (MCD, frames paired by
index or by DTW) and, for the diarizer, the overlap-aware DER (with a
collar), cluster purity and the silhouette score."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """EER from pair scores and binary same-speaker labels: (fpr + fnr) / 2
    at the threshold where |fnr - fpr| is least; inf when every label is
    the same."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    if labels.min() == labels.max():
        return float("inf")
    order = np.argsort(-scores)
    labels_sorted = labels[order]
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    tp = np.cumsum(labels_sorted)
    fp = np.cumsum(1 - labels_sorted)
    fpr = fp / max(n_neg, 1)
    fnr = 1.0 - tp / max(n_pos, 1)
    i = np.argmin(np.abs(fnr - fpr))
    return float((fpr[i] + fnr[i]) / 2.0)


def all_pairs_eer(embeddings: np.ndarray, speaker_ids: np.ndarray) -> float:
    """The EER of the cosine scores of every pair of embeddings."""
    e = embeddings / np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-8)
    sim = e @ e.T
    iu = np.triu_indices(len(e), k=1)
    labels = (speaker_ids[iu[0]] == speaker_ids[iu[1]]).astype(np.int64)
    return compute_eer(sim[iu], labels)


def log_mel_to_cepstra(log_mel: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """Orthonormal DCT-II of a log-mel sequence [T, M] -> cepstra [T, n_mfcc]
    coefficients c_1..c_n (c_0, the frame energy, excluded per standard MCD
    practice)."""
    log_mel = np.asarray(log_mel, np.float64)
    M = log_mel.shape[-1]
    n = np.arange(M)
    k = np.arange(1, n_mfcc + 1)
    basis = np.cos(np.pi * (n[None, :] + 0.5) * k[:, None] / M) \
        * np.sqrt(2.0 / M)                                   # [n_mfcc, M]
    return log_mel @ basis.T


def mel_cepstral_distortion(mel_a: np.ndarray, mel_b: np.ndarray,
                            n_mfcc: int = 13, align: bool = False) -> float:
    """Standard MCD (dB) between two log-mel sequences [T, n_mels]
    (BASELINE.json fidelity metric).

    DCTs each sequence to n_mfcc cepstral coefficients (excluding c0), then
    applies 10/ln10 * sqrt(2 * sum_d (c_a - c_b)^2) averaged over frames.
    With align=True the frame pairing comes from a DTW path over the
    per-frame cepstral distance (for unaligned synthesis/reference pairs);
    otherwise frames are paired by index with truncation to the shorter
    sequence."""
    ca = log_mel_to_cepstra(mel_a, n_mfcc)
    cb = log_mel_to_cepstra(mel_b, n_mfcc)
    K = 10.0 / np.log(10.0) * np.sqrt(2.0)
    if not align:
        t = min(len(ca), len(cb))
        d = np.linalg.norm(ca[:t] - cb[:t], axis=1)
        return float(K * np.mean(d))
    # DTW over the full pairwise cepstral-distance matrix
    D = np.linalg.norm(ca[:, None, :] - cb[None, :, :], axis=-1)
    Ta, Tb = D.shape
    acc = np.full((Ta + 1, Tb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, Ta + 1):
        prev = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])
        row = acc[i]
        row[0] = np.inf
        for j in range(1, Tb + 1):
            row[j] = D[i - 1, j - 1] + min(prev[j - 1], row[j - 1])
    # path length = backtrack count; use average cost per step
    i, j, steps, cost = Ta, Tb, 0, 0.0
    while i > 0 and j > 0:
        cost += D[i - 1, j - 1]
        steps += 1
        moves = [(acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1)]
        _, i, j = min(moves)
    return float(K * cost / max(steps, 1))


def _layered_grids(segments, spk_index, n: int, step: float):
    """Rasterize possibly-overlapping segments into two label layers
    (-1 = none). A frame's second layer is only set when a SECOND
    distinct speaker covers it."""
    g1 = np.full(n, -1)
    g2 = np.full(n, -1)
    for s, e, spk in segments:
        lo, hi = int(s / step), int(e / step)
        r = spk_index[spk]
        seg = g1[lo:hi]
        taken = (seg >= 0) & (seg != r)
        g2[lo:hi][taken] = r
        g1[lo:hi][~taken] = r
    return g1, g2


def diarization_error_rate(ref_segments: Sequence[Tuple[float, float, str]],
                           hyp_segments: Sequence[Tuple[float, float, str]],
                           step: float = 0.01,
                           collar: float = 0.0) -> float:
    """Frame-based NIST-style DER with greedy speaker mapping
    (host-side replacement for pyannote's DER, cli.py:179-188).

    Overlap-aware on BOTH sides (up to two simultaneous speakers per
    frame per side): per scored frame with reference speaker set R and
    mapped hypothesis set H, error = max(|R|,|H|) - |R ∩ H| (the combined
    miss + false-alarm + confusion count), divided by total reference
    speaker time sum(|R|). An overlapped frame therefore needs BOTH
    speakers in the hypothesis for full credit — matching one of two is
    half an error (round-3's match-either scoring gave full credit and
    made multi-speaker overlap output worthless to emit).

    `collar` excludes frames within +-collar seconds of any reference
    boundary from scoring (pyannote's convention; 0.25 s is the common
    reporting value, 0.0 the strict default)."""
    if not ref_segments:
        return 0.0
    end = max(max(e for _, e, _ in ref_segments),
              max((e for _, e, _ in hyp_segments), default=0.0))
    n = int(np.ceil(end / step)) + 1
    ref_spk = sorted({s for _, _, s in ref_segments})
    hyp_spk = sorted({s for _, _, s in hyp_segments})
    r1, r2 = _layered_grids(ref_segments,
                            {s: i for i, s in enumerate(ref_spk)}, n, step)
    h1, h2 = _layered_grids(hyp_segments,
                            {s: i for i, s in enumerate(hyp_spk)}, n, step)
    # greedy mapping hyp->ref by co-occurrence time (either layer)
    counts = np.zeros((len(hyp_spk), len(ref_spk)))
    for h in range(len(hyp_spk)):
        hp = (h1 == h) | (h2 == h)
        for r in range(len(ref_spk)):
            counts[h, r] = np.sum(hp & ((r1 == r) | (r2 == r)))
    mapping = {}
    while counts.size and counts.max() > 0:
        h, r = np.unravel_index(np.argmax(counts), counts.shape)
        mapping[h] = r
        counts[h, :] = -1
        counts[:, r] = -1
    # remap hyp layers into ref ids; unmapped speakers -> -2 (present,
    # never matches)
    lut = np.array([mapping.get(h, -2) for h in range(len(hyp_spk))] + [-1])
    h1 = lut[h1]  # -1 indexes the sentinel tail -> stays -1
    h2 = lut[h2]
    scored = np.ones(n, bool)
    if collar > 0.0:
        half = int(round(collar / step))
        for s, e, _ in ref_segments:
            for b in (int(s / step), int(e / step)):
                scored[max(b - half, 0):b + half] = False
    n_ref = (r1 >= 0).astype(int) + (r2 >= 0).astype(int)
    n_hyp = (h1 != -1).astype(int) + (h2 != -1).astype(int)
    # each hyp layer matches at most one ref layer (layers hold distinct
    # speakers by construction), so the frame intersection is a plain sum
    inter = (((h1 == r1) & (r1 >= 0)) | ((h1 == r2) & (r2 >= 0))
             ).astype(int) + (((h2 == r1) & (r1 >= 0))
                              | ((h2 == r2) & (r2 >= 0))).astype(int)
    errors = np.sum((np.maximum(n_ref, n_hyp) - inter)[scored])
    total = max(np.sum(n_ref[scored]), 1)
    return float(errors / total)


def cluster_purity(assignments: np.ndarray, truth: np.ndarray) -> float:
    total = len(assignments)
    if total == 0:
        return 1.0
    pure = 0
    for c in np.unique(assignments):
        members = truth[assignments == c]
        if len(members):
            _, counts = np.unique(members, return_counts=True)
            pure += counts.max()
    return float(pure / total)


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Plain-numpy silhouette (Eval_Acoustic.py's sklearn call)."""
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    if len(uniq) < 2 or len(x) < 3:
        return 0.0
    d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    s = np.zeros(len(x))
    for i in range(len(x)):
        same = labels == labels[i]
        same[i] = False
        a = d[i][same].mean() if same.any() else 0.0
        b = min(d[i][labels == c].mean() for c in uniq if c != labels[i])
        s[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
    return float(s.mean())
