"""Similarity, clustering, and cross-job speaker re-identification
(``ttsx/pipeline/diarizer/cluster.py``, copied line for line: it is
numpy on the host in both packages, and equal inputs give equal outputs).

Re-designs hyper_diarizer/cluster.py (658 LoC):
  * time_aware_sim (cluster.py:612-648): cosine blended 50/50 with a
    prob-modulated exp(-dt/2) temporal kernel, min-max normalized.
  * GreedyModularityClusterer (cluster.py:128-162): networkx-free greedy
    modularity communities over the sim>threshold graph.
  * KMeansClusterer (the GNNClusterer's k=ceil(sqrt(n)) KMeans core;
    the GAT layers are replaced by the embedder's attention
    contextualization pass).
  * ReIDMemory (cluster.py:280-610): per-speaker deque memory (10),
    momentum-0.99 prototypes, z-score anomaly filter (IsolationForest
    stand-in), cosine match >= 0.6 else new UUID speaker, GMM-free
    2-means threshold auto-tune, exact matmul top-k matching (in place
    of FAISS — SURVEY §2.9), pickle snapshot/load, callbacks.
"""
from __future__ import annotations

import pickle
import uuid
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------
def time_aware_sim(embs: np.ndarray, starts: np.ndarray,
                   probs: Optional[np.ndarray] = None,
                   tau: float = 2.0) -> np.ndarray:
    e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    cos = e @ e.T
    dt = np.abs(starts[:, None] - starts[None, :])
    temporal = np.exp(-dt / tau)
    if probs is not None:
        temporal = temporal * np.sqrt(probs[:, None] * probs[None, :])
    sim = 0.5 * cos + 0.5 * temporal
    lo, hi = sim.min(), sim.max()
    return (sim - lo) / (hi - lo + 1e-8)


# ---------------------------------------------------------------------------
# clusterers
# ---------------------------------------------------------------------------
class Clusterer:
    def cluster(self, sim: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class GreedyModularityClusterer(Clusterer):
    """Greedy modularity maximization over the sim > threshold graph."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def cluster(self, sim: np.ndarray) -> np.ndarray:
        n = len(sim)
        if n == 0:
            return np.zeros(0, int)
        adj = (sim > self.threshold).astype(np.float64)
        np.fill_diagonal(adj, 0.0)
        w = adj * sim
        m2 = w.sum() + 1e-12
        deg = w.sum(axis=1)
        labels = np.arange(n)
        improved = True
        while improved:
            improved = False
            for i in range(n):
                best_gain, best_c = 0.0, labels[i]
                for c in np.unique(labels):
                    if c == labels[i]:
                        continue
                    members = labels == c
                    gain = (w[i, members].sum() / m2
                            - deg[i] * deg[members].sum() / (m2 * m2))
                    own = labels == labels[i]
                    own[i] = False
                    gain -= (w[i, own].sum() / m2
                             - deg[i] * deg[own].sum() / (m2 * m2))
                    if gain > best_gain + 1e-12:
                        best_gain, best_c = gain, c
                if best_c != labels[i]:
                    labels[i] = best_c
                    improved = True
        # compact label ids
        _, out = np.unique(labels, return_inverse=True)
        return out


class KMeansClusterer(Clusterer):
    """k = ceil(sqrt(n)) k-means on embeddings (GNNClusterer core)."""

    def __init__(self, k: Optional[int] = None, iters: int = 50,
                 seed: int = 0):
        self.k = k
        self.iters = iters
        self.seed = seed

    def cluster_embeddings(self, embs: np.ndarray) -> np.ndarray:
        n = len(embs)
        if n == 0:
            return np.zeros(0, int)
        k = self.k or int(np.ceil(np.sqrt(n)))
        k = min(k, n)
        rng = np.random.default_rng(self.seed)
        centers = embs[rng.choice(n, k, replace=False)]
        assign = np.zeros(n, int)
        for _ in range(self.iters):
            d = ((embs[:, None] - centers[None]) ** 2).sum(-1)
            new_assign = d.argmin(1)
            if (new_assign == assign).all():
                break
            assign = new_assign
            for i in range(k):
                if (assign == i).any():
                    centers[i] = embs[assign == i].mean(0)
        return assign

    def cluster(self, sim: np.ndarray) -> np.ndarray:
        # spectral-style: use sim rows as features
        return self.cluster_embeddings(sim)


def spectral_cluster(embs: np.ndarray, k: Optional[int] = None,
                     max_k: int = 10, prune_pct: float = 40.0
                     ) -> np.ndarray:
    """Normalized-Laplacian spectral clustering with eigengap speaker
    count estimation — the production diarization first pass.

    Why (VERDICT r3 weak #4): on the hard stream the modularity
    clusterer both over-counts speakers (9-11 hyp vs 6 true) and has no
    principled count estimate. The eigengap of the normalized Laplacian
    IS that estimate: k = argmax of the gap in the smallest eigenvalues.
    Affinity is cosine with per-row percentile pruning (weak links are
    mostly noise at 12 dB SNR), symmetrized."""
    n = len(embs)
    if n == 0:
        return np.zeros(0, int)
    if n == 1:
        return np.zeros(1, int)
    e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    aff = np.clip(e @ e.T, 0.0, None)
    np.fill_diagonal(aff, 0.0)
    if prune_pct > 0:
        floor = np.percentile(aff, prune_pct, axis=1, keepdims=True)
        aff = np.where(aff >= floor, aff, 0.0)
        aff = 0.5 * (aff + aff.T)  # re-symmetrize after row pruning
    d = aff.sum(axis=1)
    dinv = 1.0 / np.sqrt(d + 1e-8)
    lap = np.eye(n) - dinv[:, None] * aff * dinv[None, :]
    w, v = np.linalg.eigh(lap)
    if k is None:
        kmax = int(min(max_k, n - 1))
        gaps = np.diff(w[: kmax + 1])
        k = int(np.argmax(gaps)) + 1
    k = int(np.clip(k, 1, n))
    if k == 1:
        return np.zeros(n, int)
    vecs = v[:, :k]
    vecs = vecs / (np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-8)
    return KMeansClusterer(k=k).cluster_embeddings(vecs)


def stitch_segments(slices: Sequence[Tuple[float, float]],
                    labels: np.ndarray, embs: np.ndarray,
                    max_gap: float = 0.3):
    """Merge chronologically adjacent same-label windows into segments
    (the inverse of the controller's uniform sub-segmentation). Returns
    (segments, segment_labels, segment_embs) with segment embeddings the
    L2-normalized mean of their member windows."""
    if not len(slices):
        return list(slices), np.asarray(labels), embs
    order = sorted(range(len(slices)), key=lambda i: slices[i][0])
    segs: List[List[float]] = []
    seg_labels: List[int] = []
    members: List[List[int]] = []
    for i in order:
        s, e = slices[i]
        if (segs and int(labels[i]) == seg_labels[-1]
                and s - segs[-1][1] <= max_gap):
            segs[-1][1] = max(segs[-1][1], e)
            members[-1].append(i)
        else:
            segs.append([s, e])
            seg_labels.append(int(labels[i]))
            members.append([i])
    seg_embs = np.stack([embs[m].mean(axis=0) for m in members])
    seg_embs = seg_embs / (np.linalg.norm(seg_embs, axis=1, keepdims=True)
                           + 1e-8)
    return ([(s, e) for s, e in segs], np.asarray(seg_labels, int),
            seg_embs)


def temporal_cluster(embs: np.ndarray, starts: np.ndarray,
                     probs: Optional[np.ndarray] = None,
                     method: str = "modularity") -> np.ndarray:
    sim = time_aware_sim(embs, starts, probs)
    if method == "kmeans":
        return KMeansClusterer().cluster_embeddings(embs)
    if method == "spectral":
        return spectral_cluster(embs)
    return GreedyModularityClusterer().cluster(sim)


def merge_clusters(embs: np.ndarray, labels: np.ndarray,
                   thresh: float = 0.75) -> np.ndarray:
    """Agglomerative prototype merge: repeatedly fuse the two clusters
    whose L2-normalized mean embeddings have the highest cosine, while
    that cosine >= `thresh`.

    The hard-stream failure this fixes (VERDICT r3 weak #4): the
    modularity clusterer over-fragments noisy streams (11 hypothesis
    speakers for 6 true ones), and the time-aware similarity kernel
    punishes far-apart turns of the SAME speaker, so fragments of one
    speaker never rejoin. Prototype cosine is time-free, and merging at
    the prototype level (mean of many slices) is far more robust than
    any single-slice link."""
    labels = np.asarray(labels).copy()
    if len(labels) == 0:
        return labels
    while True:
        ids = np.unique(labels)
        if len(ids) < 2:
            break
        protos = np.stack([embs[labels == c].mean(0) for c in ids])
        protos = protos / (np.linalg.norm(protos, axis=1, keepdims=True)
                           + 1e-8)
        cos = protos @ protos.T
        np.fill_diagonal(cos, -1.0)
        i, j = np.unravel_index(np.argmax(cos), cos.shape)
        if cos[i, j] < thresh:
            break
        labels[labels == ids[j]] = ids[i]
    _, out = np.unique(labels, return_inverse=True)
    return out


# ---------------------------------------------------------------------------
# callbacks (cluster.py:50-104)
# ---------------------------------------------------------------------------
class ReIDCallback:
    def on_match(self, slice_idx: int, speaker: str, score: float): ...
    def on_new_speaker(self, slice_idx: int, speaker: str): ...


class PairCollector(ReIDCallback):
    """Collects (emb, speaker) pairs for contrastive refresh
    (cluster.py:91-104)."""

    def __init__(self):
        self.pairs: List[Tuple[int, str, float]] = []

    def on_match(self, slice_idx, speaker, score):
        self.pairs.append((slice_idx, speaker, score))


class WandBCallback(ReIDCallback):
    """Optional W&B score logging (cluster.py:73-89); no-op without wandb."""

    def __init__(self, project: str = "ttsx-reid"):
        try:
            import wandb
            self.run = wandb.init(project=project, reinit=True)
        except Exception:
            self.run = None

    def on_match(self, slice_idx, speaker, score):
        if self.run is not None:
            self.run.log({"reid_score": score})


# ---------------------------------------------------------------------------
# re-identification memory
# ---------------------------------------------------------------------------
class ReIDMemory:
    """Cross-job speaker memory with momentum prototypes."""

    def __init__(self, match_threshold: float = 0.6, memory_size: int = 10,
                 momentum: float = 0.99, anomaly_z: float = 2.5,
                 auto_tune: bool = True,
                 callbacks: Optional[Sequence[ReIDCallback]] = None):
        self.match_threshold = match_threshold
        self.memory_size = memory_size
        self.momentum = momentum
        self.anomaly_z = anomaly_z
        self.auto_tune = auto_tune
        self.callbacks = list(callbacks or [])
        self.memory: Dict[str, deque] = {}
        self.prototypes: Dict[str, np.ndarray] = {}
        self._match_scores: List[float] = []

    # -- anomaly filter (IsolationForest stand-in: z-score on norm+cos) ---
    def _filter_anomalies(self, embs: np.ndarray) -> np.ndarray:
        if len(embs) < 4:
            return np.ones(len(embs), bool)
        center = embs.mean(0)
        d = np.linalg.norm(embs - center, axis=1)
        z = (d - d.mean()) / (d.std() + 1e-8)
        return z < self.anomaly_z

    def _proto_matrix(self):
        if not self.prototypes:
            return None, []
        names = sorted(self.prototypes)
        mat = np.stack([self.prototypes[n] for n in names])
        mat = mat / (np.linalg.norm(mat, axis=1, keepdims=True) + 1e-8)
        return mat, names

    def _tune_threshold(self):
        """2-means split of match scores (GMM threshold auto-tune,
        cluster.py:366-375)."""
        if not self.auto_tune or len(self._match_scores) < 20:
            return
        s = np.sort(np.asarray(self._match_scores[-200:]))
        lo, hi = s.mean() - s.std(), s.mean() + s.std()
        for _ in range(10):
            mid = (lo + hi) / 2
            a = s[s < mid]
            b = s[s >= mid]
            if not len(a) or not len(b):
                break
            lo, hi = a.mean(), b.mean()
        self.match_threshold = float(np.clip((lo + hi) / 2, 0.4, 0.85))

    def re_id(self, cluster_embs: Dict[int, np.ndarray],
              ) -> Tuple[Dict[int, str], Dict[int, float]]:
        """cluster_id -> mean embedding; returns (mapping, certainties)."""
        mapping: Dict[int, str] = {}
        certainty: Dict[int, float] = {}
        for cid, embs in cluster_embs.items():
            embs = np.atleast_2d(embs)
            keep = self._filter_anomalies(embs)
            emb = embs[keep].mean(0) if keep.any() else embs.mean(0)
            emb = emb / (np.linalg.norm(emb) + 1e-8)

            mat, names = self._proto_matrix()
            if mat is not None:
                scores = mat @ emb  # exact top-k: one matmul (no FAISS)
                best = int(np.argmax(scores))
                score = float(scores[best])
                self._match_scores.append(score)
                if score >= self.match_threshold:
                    spk = names[best]
                    mapping[cid] = spk
                    certainty[cid] = score
                    self._update(spk, emb)
                    for cb in self.callbacks:
                        cb.on_match(cid, spk, score)
                    continue
            spk = f"spk-{uuid.uuid4().hex[:8]}"
            mapping[cid] = spk
            certainty[cid] = 1.0 if mat is None else float(
                1.0 - np.max(mat @ emb))
            self._new_speaker(spk, emb)
            for cb in self.callbacks:
                cb.on_new_speaker(cid, spk)
        self._tune_threshold()
        return mapping, certainty

    def _new_speaker(self, spk: str, emb: np.ndarray):
        self.memory[spk] = deque([emb], maxlen=self.memory_size)
        self.prototypes[spk] = emb.copy()

    def _update(self, spk: str, emb: np.ndarray):
        self.memory[spk].append(emb)
        m = self.momentum
        proto = m * self.prototypes[spk] + (1 - m) * emb
        self.prototypes[spk] = proto / (np.linalg.norm(proto) + 1e-8)

    # legacy API (reid.py memory.update)
    def update(self, spk: str, emb: np.ndarray):
        emb = emb / (np.linalg.norm(emb) + 1e-8)
        if spk in self.prototypes:
            self._update(spk, emb)
        else:
            self._new_speaker(spk, emb)

    # -- temporal context + smoothing (cluster.py:453-458, 496-501) -------
    @staticmethod
    def tcn_context(embs: np.ndarray, starts: np.ndarray,
                    kernel: int = 3, dilations=(1, 2)) -> np.ndarray:
        """Dilated causal temporal smoothing over the slice sequence (the
        reference's TCN context + 2-source gating fusion): each slice's
        embedding is blended with exponentially-time-weighted causal
        neighbors, gated by cosine agreement."""
        order = np.argsort(starts)
        e = embs[order]
        e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-8)
        out = e.copy()
        for dil in dilations:
            ctx = np.zeros_like(out)
            wsum = np.zeros(len(out))
            for k in range(1, kernel):
                idx = np.arange(len(out)) - k * dil
                valid = idx >= 0
                w = np.exp(-k * 0.5)
                ctx[valid] += w * out[idx[valid]]
                wsum[valid] += w
            has = wsum > 0
            ctx[has] /= wsum[has, None]
            # gate: agree -> blend, disagree -> keep own
            gate = np.clip((out * ctx).sum(1, keepdims=True), 0.0, 1.0)
            out = out + 0.5 * gate * ctx
            out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-8
        result = np.empty_like(out)
        result[order] = out
        return result

    @staticmethod
    def smooth_labels(labels: np.ndarray, starts: np.ndarray,
                      embs: Optional[np.ndarray] = None,
                      window: int = 2) -> np.ndarray:
        """Positional-context label smoothing (the reference's transformer
        smoothing with start-time positional encoding): flip isolated
        single-slice speaker switches to the local majority — but only
        when the slice's own embedding actually sides with the majority
        cluster (alternating two-party speech must NOT be flattened)."""
        order = np.argsort(starts)
        lab = labels[order].copy()
        e = None
        if embs is not None:
            e = embs[order]
            e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-8)
        for i in range(1, len(lab) - 1):
            lo = max(0, i - window)
            hi = min(len(lab), i + window + 1)
            neigh = np.concatenate([lab[lo:i], lab[i + 1:hi]])
            if not len(neigh) or not (neigh != lab[i]).all():
                continue
            vals, counts = np.unique(neigh, return_counts=True)
            maj = vals[np.argmax(counts)]
            if e is not None:
                own = lab == lab[i]
                own[i] = False
                own_sim = (e[i] @ e[own].mean(0)) if own.any() else -1.0
                maj_sim = e[i] @ e[lab == maj].mean(0)
                if own_sim >= maj_sim:
                    continue  # embedding sides with its own cluster
            lab[i] = maj
        out = np.empty_like(lab)
        out[order] = lab
        return out

    # -- NT-Xent online contrastive refresh (cluster.py:503-517) ----------
    def contrastive_refresh(self, embs: np.ndarray, speakers: Sequence[str],
                            temperature: float = 0.1, lr: float = 0.05,
                            steps: int = 10):
        """Refine prototypes from PairCollector-style (emb, speaker) pairs:
        gradient of the NT-Xent loss w.r.t. each prototype, applied
        directly (prototypes are the only 'parameters' the host keeps)."""
        names = [s for s in speakers if s in self.prototypes]
        if not names:
            return
        e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        for _ in range(steps):
            mat, pnames = self._proto_matrix()
            if mat is None:
                return
            sim = e @ mat.T / temperature                # [n, P]
            p = np.exp(sim - sim.max(axis=1, keepdims=True))
            p /= p.sum(axis=1, keepdims=True)
            for i, spk in enumerate(speakers):
                if spk not in self.prototypes:
                    continue
                j = pnames.index(spk)
                grad = -e[i] * (1 - p[i, j])             # pull own proto
                for k in range(len(pnames)):
                    if k != j:
                        grad_k = e[i] * p[i, k]          # push others
                        proto = self.prototypes[pnames[k]] - lr * grad_k
                        self.prototypes[pnames[k]] = proto / (
                            np.linalg.norm(proto) + 1e-8)
                proto = self.prototypes[spk] - lr * grad
                self.prototypes[spk] = proto / (np.linalg.norm(proto) + 1e-8)

    # -- persistence (cluster.py:568-589) ---------------------------------
    def snapshot(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({
                "memory": {k: list(v) for k, v in self.memory.items()},
                "prototypes": self.prototypes,
                "match_threshold": self.match_threshold,
            }, f)

    def load_snapshot(self, path: str):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.memory = {k: deque(v, maxlen=self.memory_size)
                       for k, v in data["memory"].items()}
        self.prototypes = data["prototypes"]
        self.match_threshold = data.get("match_threshold",
                                        self.match_threshold)
