"""Slim exports (``ttsx/train/slim_export.py``): inference-only parameters
in the reference's npz format, which ``ttsx.train.slim_export`` reads.

``save_slim(path, trees)`` writes each named entry, a module (converted
by ``weights.to_flax``) or a tree of arrays (a trainer's tree from
``params_tree``, the ``_meta`` values), as
``<name>|['a']['b']``; float32 leaves of 1,024 values or more are stored
float16, as the reference stores them (``weights.save_slim_npz``).
``load_slim(path, templates)`` fills each named module of ``templates``
from the file, strictly: a module given as a flax variables tree
(``{"params": ...}``) through ``load_flax``, a trainer's parameter tree
(the speaker encoder's ``{"model": ..., "arcface_w": ...}``) through
``from_flax_params``. ``allow_missing`` lets leaves the file lacks keep
their module values: all of them (True, each reported on stderr) or
those whose path contains one of the given substrings; any other missing
or surplus key raises. ``load_slim_meta`` reads the ``_meta`` entries.

``save_vocoder_slim`` writes the generator's EMA (its live parameters
when it keeps none) as ``gen_ema``, the GST as ``gst`` and the metadata
as ``_meta``. ``load_vocoder_slim`` warm-starts a fresh ``VocoderBlock``
from such a file, the zoo's ``vocoder.npz`` included: the generator's
parameters and EMA and the GST's parameters take the file's values; the
discriminators and every optimizer start fresh, as the reference's warm
start does. A ``scale_proj`` (zero-init, added to the model after some
exports were written) may be absent and keeps its fresh value.
"""
from __future__ import annotations

import sys
from typing import Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch

from ttsx_torch.weights import (WeightMismatch, from_flax_params, load_flax,
                                load_slim_npz, save_slim_npz, to_flax)

# parameters an older export may lack: zero-init, so the warm-started
# forward is the exported model's until trained
WARM_START_OK = ("scale_proj",)


def save_slim(path: str, trees: Mapping[str, object]) -> None:
    """Write ``trees`` (name -> module or flax tree; ``_meta`` a dict of
    values) as one compressed npz, replaced atomically."""
    save_slim_npz(path, {name: to_flax(t) if isinstance(t, torch.nn.Module)
                         else t for name, t in trees.items()})


def _fill_missing(fresh: Dict, have: Dict, what: str, allow) -> tuple:
    """``have`` with the leaves of ``fresh`` it lacks, when ``allow``
    permits each; returns (tree, the paths filled)."""
    filled = []

    def merge(have, fresh, path):
        out = dict(have)
        for k, v in fresh.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = merge(have.get(k, {}), v, p)
            elif k not in have:
                if not (allow is True or any(s in p for s in allow)):
                    raise WeightMismatch(f"{what}: slim export lacks {p}")
                filled.append(p)
                out[k] = v
        return out
    return merge(have, fresh, ""), filled


def params_tree(module: torch.nn.Module) -> Dict:
    """A trainer's parameter tree of ``module``: each child's flax
    variables tree under its name and the module's own parameters beside
    them (the speaker encoder's ``{"model": ..., "arcface_w": ...}``)."""
    out = {n: to_flax(c) for n, c in module.named_children()}
    out.update({n: p.detach().cpu().numpy()
                for n, p in module.named_parameters(recurse=False)})
    return out


def load_slim(path: str, templates: Mapping[str, torch.nn.Module],
              allow_missing: Union[bool, Iterable[str]] = False
              ) -> Dict[str, torch.nn.Module]:
    """Fill each module of ``templates`` from the file's entry of its name
    (see the module docstring); returns ``templates``."""
    trees = load_slim_npz(path)
    allow = (allow_missing if isinstance(allow_missing, bool)
             else tuple(allow_missing))
    missing = []
    for name, module in templates.items():
        if name not in trees:
            raise WeightMismatch(f"{path}: no {name!r} tree")
        tree = trees[name]
        if allow:
            fresh = (to_flax(module) if "params" in tree
                     else params_tree(module))
            tree, filled = _fill_missing(fresh, tree, name, allow)
            missing += [f"{name}{p}" for p in filled]
        if "params" in tree:
            load_flax(module, tree)
        else:
            module.load_state_dict(from_flax_params(module, tree))
    if missing:
        print(f"load_slim: {len(missing)} leaves absent from {path!r} kept "
              f"their module values: {missing}", file=sys.stderr)
    return dict(templates)


def load_slim_meta(path: str) -> Dict[str, np.ndarray]:
    """The ``_meta`` entries of a slim export (empty when it has none)."""
    return load_slim_npz(path).get("_meta", {})


def save_vocoder_slim(path: str, block, meta: Optional[Dict] = None) -> None:
    gen = block.states["gen"]
    trees = {"gen_ema": to_flax(gen.module, gen.eval_params(use_ema=True)),
             "gst": block.gst}
    if meta:
        trees["_meta"] = meta
    save_slim(path, trees)


def load_vocoder_slim(path: str, block) -> Dict[str, np.ndarray]:
    """Load ``path`` into ``block`` (see the module docstring); returns the
    export's ``_meta`` entries."""
    load_slim(path, {"gen_ema": block.gen, "gst": block.gst},
              allow_missing=WARM_START_OK)
    block.states["gen"].reset_ema()
    return load_slim_meta(path)
