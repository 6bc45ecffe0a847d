"""Shared helpers of the ttsx <-> ttsx_torch parity tests.

Inputs come from numpy with a fixed seed and go through both the JAX
module (on the CPU) and its port (``device="cpu"``); weights are the JAX
module's own init, perturbed so that zero-initialised layers carry signal,
and reach the port through ``ttsx_torch.weights.from_flax``.
"""
from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttsx_torch.weights import load_flax


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test: the suite runs several
    workers on the same cores, and torch's thread pool spinning beside
    them slows training steps by about 90x (two runs of 3 steps of a tiny
    three-block trainer, 6 processes on 8 CPU cores: 460 s each with 8
    threads, 5 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def perturb(variables, seed: int = 0, scale: float = 0.1):
    """Numpy copy of a flax variables tree with N(0, scale) noise added to
    every ``params`` leaf (other collections untouched)."""
    rng = np.random.default_rng(seed)
    out = to_numpy(variables)
    out["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * scale).astype(a.dtype),
        out["params"])
    return out


def port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """``module`` filled from a flax variables tree, in eval mode."""
    return load_flax(module, to_numpy(variables)).eval()


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def close(got, ref, rtol: float, atol: float):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(ref), rtol=rtol, atol=atol)


def init_like(jax_module, *args, seed: int = 0, scale: float = 0.05, **kw):
    """A variables tree with the structure and shapes of
    ``jax_module.init(*args)`` (taken by ``jax.eval_shape``, no compile)
    and seeded random values: norm scales 1 + noise, VQ cluster sizes in
    [0.5, 2], VQ sums N(0, 1), every other leaf N(0, scale)."""
    shapes = jax.eval_shape(
        lambda: jax_module.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "cluster_size" in name:
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if "embed_sum" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        v = (rng.standard_normal(s.shape) * scale).astype(np.float32)
        return v + 1.0 if "scale" in name else v

    return jax.tree_util.tree_map_with_path(fill, shapes)


class Names:
    """uuid.uuid4 stand-in: 1, 2, 3, ... as hex (new speakers are named
    from ``uuid.uuid4``; replaced by a fresh ``Names()`` before each
    package's run, both name their speakers alike)."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return types.SimpleNamespace(hex=f"{self.n:08x}")


def same(a, b, path="out"):
    """Exact equality through dicts, sequences and arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) == type(b) and a == b, (path, a, b)


@functools.lru_cache(maxsize=None)
def two_speaker_wav():
    """An 8 s two-speaker stream (ToneCorpus, overlapped onsets, 20 dB
    SNR) and its truth segments."""
    from ttsx.core.config import AudioConfig
    from ttsx.data.tonecorpus import ToneCorpus
    corpus = ToneCorpus(n_speakers=2, audio=AudioConfig(), seed=3)
    wav, truth, _ = corpus.dialogue_hard([0, 1], 6, noise_db=20.0,
                                         overlap_prob=0.4, seed=3)
    return wav, truth


@functools.lru_cache(maxsize=None)
def tiny_encoder():
    """(RefEncConfig kwargs, the reference's variables tree as numpy):
    ECAPA 32 channels, speaker_dim 32."""
    from ttsx.core.config import RefEncConfig
    from ttsx.models.reference_encoder import ReferenceEncoder
    kw = dict(speaker_dim=32, ecapa_channels=32, num_speakers=2)
    model = ReferenceEncoder(RefEncConfig(**kw))
    tree = init_like(model, jnp.zeros((1, 256, 80)),
                     jnp.ones((1, 256), bool), seed=1, scale=0.2)
    return kw, to_numpy(tree)


def jitted(emb):
    """The reference embedder ``emb`` with its encoder's apply jitted."""
    emb._ensure_model(emb.au.n_mels)
    emb._model = types.SimpleNamespace(apply=jax.jit(emb._model.apply))
    return emb
