"""Flax parameter trees and slim npz exports -> the port's state dicts.

The port's modules name their submodules and raw parameters after the
flax tree (``conformer_0.MHSA_0``, ``band_tower.tower.res_0_1``,
``pos_bias``), so ``from_flax`` walks a flax tree and a module together:

* a module with ``from_flax_leaves`` is a leaf layer (Dense, Conv1d,
  ConvTranspose1d, LayerNorm, GroupNorm, Embed, the attention heads) and
  converts its flax leaves to torch layouts itself;
* a module with ``flax_inner`` sits one flax level higher than its
  parameters (``Conv1d`` holds ``Conv_0``; ``MHSA`` holds
  ``MultiHeadDotProductAttention_0``);
* any other flax leaf fills the parameter or buffer of the same name.

Both the ``params`` and the ``vq_stats`` collections load. Every flax key
that maps to nothing and every module entry no key fills is reported, and
either raises: a wrong or truncated file cannot load as a partly random
model.

A trainer's parameter tree nests a model's variables under a name beside
loose leaves (the speaker encoder's ``{"model": {"params": ...},
"arcface_w": ...}``, the emotion trainer's two models);
``from_flax_params`` maps such a tree onto a module whose children carry
those names, with the same checks.

``to_flax`` is the inverse: a module's state dict (or another one of the
same entries, such as an EMA) as a flax tree, each leaf layer converting
back with ``to_flax_leaves``; parameters go under ``params``, persistent
buffers under ``vq_stats``. ``save_slim_npz`` writes trees in the slim
export's key format.
"""
from __future__ import annotations

import itertools
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "vq_stats")
LEAF_KEYS = ("kernel", "bias", "scale", "embedding")
_KEY = re.compile(r"\['([^']*)'\]")


class WeightMismatch(KeyError):
    """Flax keys without a parameter, or parameters without a key."""


def load_slim_npz(path: str) -> Dict[str, Any]:
    """Parse a ``ttsx.train.slim_export.save_slim`` file with numpy alone.

    Keys ``<name>|['a']['b']`` become nested dicts ``{name: {a: {b: ...}}}``;
    float16 leaves come back as float32; ``_meta`` holds the export's
    metadata entries."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            name, _, path_str = key.partition("|")
            parts = _KEY.findall(path_str)
            if not parts or "".join(f"['{p}']" for p in parts) != path_str:
                raise ValueError(f"{path}: unparsable key {key!r}")
            arr = data[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node = out.setdefault(name, {})
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def _walk(module: nn.Module, tree: Mapping, prefix: str, flax_path: str,
          out: Dict[str, np.ndarray], unused: list) -> None:
    inner = getattr(module, "flax_inner", None)
    if inner is not None:
        extra = [k for k in tree if k != inner]
        unused.extend(f"{flax_path}/{k}" for k in extra)
        tree = tree.get(inner, {})
        flax_path = f"{flax_path}/{inner}"
    if hasattr(module, "from_flax_leaves"):
        unused.extend(f"{flax_path}/{k}" for k in tree if k not in LEAF_KEYS)
        for name, arr in module.from_flax_leaves(tree).items():
            out[prefix + name] = arr
        return
    children = dict(module.named_children())
    own = {n for n, _ in module.named_parameters(recurse=False)}
    own |= {n for n, _ in module.named_buffers(recurse=False)}
    for key, sub in tree.items():
        path = f"{flax_path}/{key}"
        if isinstance(sub, Mapping) and key in children:
            _walk(children[key], sub, f"{prefix}{key}.", path, out, unused)
        elif not isinstance(sub, Mapping) and key in own:
            out[prefix + key] = sub
        else:
            unused.append(path)


def from_flax(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of ``module`` from a flax variables tree
    (``{"params": ..., "vq_stats": ...}``, leaves numpy or array-like).

    Raises ``WeightMismatch`` naming every unused flax key and every
    missing state-dict entry, and ``ValueError`` on a shape mismatch."""
    out: Dict[str, np.ndarray] = {}
    unused: list = [k for k in tree if k not in COLLECTIONS]
    for col in COLLECTIONS:
        if col in tree:
            _walk(module, tree[col], "", col, out, unused)
    want = module.state_dict()
    missing = sorted(set(want) - set(out))
    unused += sorted(set(out) - set(want))
    if unused or missing:
        raise WeightMismatch(
            f"{type(module).__name__}: flax keys mapping to no parameter: "
            f"{unused}; parameters no key fills: {missing}")
    state = {}
    for k, arr in out.items():
        t = torch.tensor(np.asarray(arr), dtype=want[k].dtype)
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(t.shape)} != "
                             f"module shape {tuple(want[k].shape)}")
        state[k] = t
    return state


def from_flax_params(module: nn.Module, tree: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """State dict of ``module`` from a trainer's params tree: an entry
    naming a child of ``module`` is that child's flax variables tree
    (``{"params": ...}``); any other leaf fills ``module``'s own parameter
    of the same name. Raises as ``from_flax`` does."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    children = dict(module.named_children())
    own = dict(module.named_parameters(recurse=False))
    for key, sub in tree.items():
        if isinstance(sub, Mapping) and key in children:
            out.update({f"{key}.{k}": v for k, v in
                        from_flax(children[key], sub).items()})
        elif not isinstance(sub, Mapping) and key in own:
            t = torch.tensor(np.asarray(sub), dtype=own[key].dtype)
            if t.shape != own[key].shape:
                raise ValueError(f"{key}: flax shape {tuple(t.shape)} != "
                                 f"module shape {tuple(own[key].shape)}")
            out[key] = t
        else:
            unused.append(key)
    missing = sorted(set(module.state_dict()) - set(out))
    if unused or missing:
        raise WeightMismatch(
            f"{type(module).__name__}: keys mapping to no parameter: "
            f"{unused}; parameters no key fills: {missing}")
    return out


def to_flax(module: nn.Module,
            state: Optional[Mapping[str, torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """The flax variables tree of ``module`` with numpy leaves, from its
    state dict or from ``state`` (the same keys); ``from_flax`` of it
    gives the state back."""
    state = {k: v.detach().cpu().numpy()
             for k, v in (state or module.state_dict()).items()}
    params = {n for n, _ in module.named_parameters()}
    tree: Dict[str, Any] = {}

    def put(col, path, leaves):
        node = tree.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node.update(leaves)

    def walk(m, prefix, path):
        inner = getattr(m, "flax_inner", None)
        if inner is not None:
            path = path + [inner]
        if hasattr(m, "from_flax_leaves"):
            own = {n: state[prefix + n] for n, _ in itertools.chain(
                m.named_parameters(recurse=False),
                m.named_buffers(recurse=False)) if prefix + n in state}
            put("params", path, m.to_flax_leaves(own))
            return
        for n, _ in itertools.chain(m.named_parameters(recurse=False),
                                    m.named_buffers(recurse=False)):
            if prefix + n in state:
                put("params" if prefix + n in params else "vq_stats", path,
                    {n: state[prefix + n]})
        for n, child in m.named_children():
            walk(child, f"{prefix}{n}.", path + [n])

    walk(module, "", [])
    return tree


def _flat(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


# float32 leaves of at least this many values are stored float16, as the
# reference's exports store them
F16_MIN_SIZE = 1024


def save_slim_npz(path: str, trees: Mapping[str, Mapping]) -> None:
    """Write ``trees`` (name -> nested dict of arrays) as one compressed npz
    in ``ttsx.train.slim_export.save_slim``'s format: keys
    ``<name>|['a']['b']``, float32 leaves of ``F16_MIN_SIZE`` values or more
    stored as float16. The file is replaced atomically."""
    out = {}
    for name, tree in trees.items():
        for keys, leaf in _flat(tree):
            leaf = np.asarray(leaf)
            if leaf.dtype == np.float32 and leaf.size >= F16_MIN_SIZE:
                leaf = leaf.astype(np.float16)
            out[f"{name}|" + "".join(f"['{k}']" for k in keys)] = leaf
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)


def load_flax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``module`` in place from a flax tree (strict); returns it."""
    module.load_state_dict(from_flax(module, tree), strict=True)
    return module


def cast_float32(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast in place every float32 entry of ``module``'s state dict (its
    parameters and the persistent buffers ``from_flax`` fills: the VQ
    statistics) to ``dtype``; returns it. These are the float32 leaves of
    the flax ``params`` and ``vq_stats`` trees, which the reference
    server's bf16 switch casts. Non-persistent buffers are the constants
    the reference builds in float32 inside its forward (the S4 layers'
    ``a_diag``, the refiner's ``pe``) and stay float32; ``module.to(dtype)``
    would cast them too."""
    state = module.state_dict()
    module.load_state_dict(
        {k: v.to(dtype) if v.dtype == torch.float32 else v
         for k, v in state.items()}, assign=True)
    return module
