"""Graph-attention clusterer with triplet refinement
(``ttsx/pipeline/diarizer/gnn.py``).

Two GAT layers over the similarity graph, then k = ceil(sqrt(n))
k-means. Inference is numpy on the host, as in the reference (slice
counts are tiny). ``train`` takes the triplet-loss gradient of the same
forward with ``torch.autograd`` on ``device`` (the reference uses
``jax.value_and_grad`` pinned to the host CPU), with the same numpy
triplet sampler and plain SGD, in float32 as there; ``losses`` keeps
each step's loss of the last ``train``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ttsx_torch.pipeline.diarizer.cluster import Clusterer, KMeansClusterer


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


class GNNClusterer(Clusterer):
    """2 GAT layers over the similarity graph, then k=ceil(sqrt(n)) KMeans."""

    def __init__(self, dim: int = 64, layers: int = 2, seed: int = 0,
                 sim_threshold: float = 0.5, lr: float = 0.05):
        self.layers = layers
        self.dim = dim
        self.seed = seed
        self.sim_threshold = sim_threshold
        self.lr = lr
        self._w: Optional[list] = None
        self.losses: list = []

    def _init(self, in_dim: int):
        rng = np.random.default_rng(self.seed)
        dims = [in_dim] + [self.dim] * self.layers
        self._w = [rng.normal(scale=1 / np.sqrt(dims[i]),
                              size=(dims[i], dims[i + 1]))
                   for i in range(self.layers)]

    def _forward(self, embs: np.ndarray, adj: np.ndarray) -> np.ndarray:
        h = embs
        for w in self._w:
            z = h @ w
            # attention: masked scaled dot-product over graph edges
            att = z @ z.T / np.sqrt(z.shape[1])
            att = np.where(adj > 0, att, -1e9)
            att = _softmax_rows(att)
            h = np.tanh(att @ z)
        return h / (np.linalg.norm(h, axis=1, keepdims=True) + 1e-8)

    def cluster_embeddings(self, embs: np.ndarray) -> np.ndarray:
        n = len(embs)
        if n == 0:
            return np.zeros(0, int)
        if self._w is None or self._w[0].shape[0] != embs.shape[1]:
            self._init(embs.shape[1])
        e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        adj = (e @ e.T) > self.sim_threshold
        np.fill_diagonal(adj, True)
        h = self._forward(e, adj)
        return KMeansClusterer(seed=self.seed).cluster_embeddings(h)

    def cluster(self, sim: np.ndarray) -> np.ndarray:
        return self.cluster_embeddings(sim)

    # -- triplet refinement (cluster.py GNNClusterer.train) ---------------
    def train(self, embs: np.ndarray, labels: np.ndarray,
              margin: float = 0.3, steps: int = 20,
              triplets_per_step: int = 16, device="cuda") -> float:
        """Triplet-loss gradient refinement of ALL GAT weights: minimizes
        mean(relu(|h_a-h_p|^2 - |h_a-h_n|^2 + margin)) with the distances
        taken through the full GAT forward, differentiated by
        ``torch.autograd`` on ``device``.

        Returns the final triplet loss (nan when no anchor has both a
        same-label partner and a negative)."""
        import torch

        from ttsx_torch.core.device import resolve_device
        dev = resolve_device(device)
        if self._w is None or self._w[0].shape[0] != embs.shape[1]:
            self._init(embs.shape[1])
        e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        adj = (e @ e.T) > self.sim_threshold
        np.fill_diagonal(adj, True)
        rng = np.random.default_rng(self.seed)

        # anchors need a same-label partner AND a different-label negative;
        # skip singleton-cluster anchors instead of aborting
        counts = {l: int((labels == l).sum()) for l in set(labels.tolist())}
        valid = np.asarray([i for i in range(len(e))
                            if counts[labels[i]] >= 2
                            and counts[labels[i]] < len(e)])
        self.losses = []
        if len(valid) == 0:
            return float("nan")  # fully degenerate: nothing to learn

        def sample_triplets():
            a, p, n_ = [], [], []
            while len(a) < triplets_per_step:
                i = int(valid[rng.integers(len(valid))])
                same = np.where(labels == labels[i])[0]
                diff = np.where(labels != labels[i])[0]
                a.append(i)
                p.append(int(rng.choice(same[same != i])))
                n_.append(int(rng.choice(diff)))
            return (np.asarray(a), np.asarray(p), np.asarray(n_))

        adj_t = torch.as_tensor(adj, device=dev)
        e_t = torch.as_tensor(e, dtype=torch.float32, device=dev)

        def fwd(ws):
            h = e_t
            for w in ws:
                z = h @ w
                att = z @ z.T / float(np.sqrt(np.float32(z.shape[1])))
                att = torch.where(adj_t, att, torch.full_like(att, -1e9))
                att = torch.softmax(att, dim=1)
                h = torch.tanh(att @ z)
            return h / (torch.linalg.vector_norm(h, dim=1, keepdim=True)
                        + 1e-8)

        def loss_fn(ws, ai, pi, ni):
            h = fwd(ws)
            d_ap = torch.sum((h[ai] - h[pi]) ** 2, dim=-1)
            d_an = torch.sum((h[ai] - h[ni]) ** 2, dim=-1)
            return torch.mean(torch.relu(d_ap - d_an + margin))

        ws = [torch.tensor(w, dtype=torch.float32, device=dev,
                           requires_grad=True) for w in self._w]
        losses = []
        for _ in range(steps):
            trip = [torch.as_tensor(t, device=dev) for t in sample_triplets()]
            val = loss_fn(ws, *trip)
            grads = torch.autograd.grad(val, ws)
            with torch.no_grad():
                ws = [(w - self.lr * g).requires_grad_()
                      for w, g in zip(ws, grads)]
            losses.append(val.detach())
        self._w = [w.detach().cpu().numpy() for w in ws]
        self.losses = ([float(v) for v in torch.stack(losses).cpu()]
                       if losses else [])
        return self.losses[-1] if self.losses else 0.0
