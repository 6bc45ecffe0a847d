"""Speaker-verification EER (``ttsx/eval/metrics.py``), numpy on the host."""
from __future__ import annotations

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
