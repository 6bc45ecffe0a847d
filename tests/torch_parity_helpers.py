"""Shared helpers of the ttsx <-> ttsx_torch parity tests.

Inputs come from numpy with a fixed seed and go through both the JAX
module (on the CPU) and its port (``device="cpu"``); weights are the JAX
module's own init, perturbed so that zero-initialised layers carry signal,
and reach the port through ``ttsx_torch.weights.from_flax``.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from ttsx_torch.weights import load_flax


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
