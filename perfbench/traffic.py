"""The general generators that read a traffic file's parameters.

``serve_pool``: a pool of synthesis requests for a bucketed server. The
request lengths are the pool's quantiles of a log-normal (``median_frames``,
``sigma``) clipped to ``[min_frames, max_frames]``, so every seed gets the
same set of lengths; the seed orders them and draws each request's text
embedding, prosody, emotion, speaker and style id. Call ``i`` of a closed
loop takes the pool's requests ``i*batch .. i*batch + batch - 1`` (mod the
pool).

``write_wav_tree``: a ``<speaker>/<domain>/<style>/*.wav`` tree with
transcripts, of voiced syllables over a little noise, whose lengths are a
fixed spread from ``min_s`` to ``max_s`` in a fixed order: the seed
draws the signals and the words, never a size, so every seed gives the
trainer the same batch shapes.
"""
from __future__ import annotations

import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def _lengths(n: int, median: float, sigma: float, lo: int, hi: int):
    nd = NormalDist(math.log(median), sigma)
    return [int(min(max(round(math.exp(nd.inv_cdf((k + 0.5) / n))), lo), hi))
            for k in range(n)]


def serve_pool(params: Dict, dims: Dict[str, int], seed: int) -> List[Dict]:
    """``params["pool"]`` requests as dicts of numpy arrays (``text_emb``
    [n, text], ``prosody`` [n, cond], ``emotion_probs``, ``speaker``,
    ``style_id``); ``dims`` gives ``text``, ``cond``, ``emotion``,
    ``speaker`` and ``styles``."""
    rng = np.random.default_rng(seed)
    lengths = _lengths(params["pool"], params["median_frames"],
                       params["sigma"], params["min_frames"],
                       params["max_frames"])
    rng.shuffle(lengths)
    pool = []
    for n in lengths:
        pool.append(dict(
            text_emb=rng.standard_normal((n, dims["text"]), np.float32),
            prosody=rng.standard_normal((n, dims["cond"]), np.float32),
            emotion_probs=rng.dirichlet(np.ones(dims["emotion"])).astype(
                np.float32),
            speaker=(0.5 * rng.standard_normal(dims["speaker"])).astype(
                np.float32),
            style_id=int(rng.integers(0, dims["styles"]))))
    return pool


def call_indices(i: int, batch: int, pool: int) -> List[int]:
    return [(i * batch + j) % pool for j in range(batch)]


def write_wav_tree(root: Path, params: Dict, seed: int, write_wav) -> int:
    """The tree under ``root``: ``speakers`` x ``domains`` x ``styles`` x
    ``per_folder`` utterances at ``sample_rate``; ``write_wav(path, wav,
    sr)`` writes one file. Returns the number of utterances."""
    rng = np.random.default_rng(seed)
    sr = params["sample_rate"]
    folders = [(s, d, st) for s in range(params["speakers"])
               for d in params["domains"] for st in params["styles"]]
    n = len(folders) * params["per_folder"]
    seconds = np.linspace(params["min_s"], params["max_s"], n)
    words = params["words"].split()
    k = 0
    for s, d, style in folders:
        folder = root / f"spk{s}" / d / style
        folder.mkdir(parents=True, exist_ok=True)
        for u in range(params["per_folder"]):
            m = int(seconds[k] * sr)
            k += 1
            t = np.arange(m) / sr
            f0 = (100 + 40 * s) * (1 + 0.1 * np.sin(
                2 * np.pi * rng.uniform(0.5, 2) * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            voice = sum(np.sin(h * phase) / h for h in range(1, 6))
            env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 6) * t), 0, None)
            amp = params["amplitude"][style]
            noise = params["noise"][d]
            wav = amp * env * voice / 2 + noise * rng.standard_normal(m)
            write_wav(folder / f"u{u}.wav", wav.astype(np.float32), sr)
            (folder / f"u{u}.txt").write_text(" ".join(
                rng.choice(words, int(rng.integers(3, 9)))))
    return n
