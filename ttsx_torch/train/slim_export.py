"""Slim vocoder exports (``ttsx/train/slim_export.py``): what synthesis
needs of a trained vocoder block, in the reference's npz format.

``save_vocoder_slim`` writes the generator's EMA (its live parameters
when it keeps none) as ``gen_ema|['params']/...``, the GST as
``gst|['params']/...`` and the metadata as ``_meta|['key']``; float32
leaves of 1,024 values or more are stored float16, as the reference
stores them. ``ttsx.train.slim_export.load_vocoder_slim`` reads the file,
and so do ``ttsx_torch.zoo`` and ``load_vocoder_slim`` here.

``load_vocoder_slim`` warm-starts a fresh ``VocoderBlock`` from such a
file, the zoo's ``vocoder.npz`` included: the generator's parameters and
EMA and the GST's parameters take the file's values; the discriminators
and every optimizer start fresh, as the reference's warm start does. A
``scale_proj`` (zero-init, added to the model after some exports were
written) may be absent and keeps its fresh value; any other missing or
surplus key raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ttsx_torch.weights import (WeightMismatch, load_flax, load_slim_npz,
                                save_slim_npz, to_flax)

# parameters an older export may lack: zero-init, so the warm-started
# forward is the exported model's until trained
WARM_START_OK = ("scale_proj",)


def save_vocoder_slim(path: str, block, meta: Optional[Dict] = None) -> None:
    gen = block.states["gen"]
    trees = {"gen_ema": to_flax(gen.module, gen.eval_params(use_ema=True)),
             "gst": to_flax(block.gst)}
    if meta:
        trees["_meta"] = {k: np.asarray(v) for k, v in meta.items()}
    save_slim_npz(path, trees)


def _fill_missing(module: torch.nn.Module, tree: Dict, what: str) -> Dict:
    """``tree`` with the leaves it lacks taken from ``module``, when each
    lies under one of ``WARM_START_OK``."""
    def merge(have, fresh, path):
        out = dict(have)
        for k, v in fresh.items():
            if isinstance(v, dict):
                out[k] = merge(have.get(k, {}), v, f"{path}/{k}")
            elif k not in have:
                if not any(s in f"{path}/{k}" for s in WARM_START_OK):
                    raise WeightMismatch(f"{what}: slim export lacks "
                                         f"{path}/{k}")
                out[k] = v
        return out
    return merge(tree, to_flax(module), "")


def load_vocoder_slim(path: str, block) -> Dict[str, np.ndarray]:
    """Load ``path`` into ``block`` (see the module docstring); returns the
    export's ``_meta`` entries."""
    trees = load_slim_npz(path)
    for name, module in (("gen_ema", block.gen), ("gst", block.gst)):
        if name not in trees:
            raise WeightMismatch(f"{path}: no {name!r} tree")
        load_flax(module, _fill_missing(module, trees[name], name))
    block.states["gen"].reset_ema()
    return trees.get("_meta", {})
