"""The checked-in trained zoo (``eval_results/zoo``), served by the port.

``load_pipeline`` reads ``acoustic.npz``, ``refiner.npz`` and
``vocoder.npz`` (EMA generator + GST) with numpy alone, converts each
once into the port's modules, and moves them to ``device``: no JAX is
needed. The config is ``zoo_cfg()``: the reference's ``_tts_cfg()`` with
zoo.json's vocoder overrides and, by default, both CUDA kernel flags on
(the flags change no parameter). Every stage must be present and load
whole; a missing file or key raises.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ttsx_torch.core.config import TTSXConfig, zoo_cfg
from ttsx_torch.core.device import resolve_device

DEFAULT_ZOO = Path(__file__).resolve().parent.parent / "eval_results/zoo"


def zoo_info(zoo_dir: Optional[str] = None) -> Dict:
    meta = (Path(zoo_dir) if zoo_dir else DEFAULT_ZOO) / "zoo.json"
    return json.loads(meta.read_text())


def load_zoo_trees(zoo_dir: Optional[str] = None) -> Dict[str, Dict]:
    """Flax trees of the four synthesis modules plus the vocoder export's
    ``_meta``, as numpy: {acoustic, refiner, generator, gst, vocoder_meta}."""
    from ttsx_torch.weights import load_slim_npz
    zd = Path(zoo_dir) if zoo_dir else DEFAULT_ZOO
    voc = load_slim_npz(str(zd / "vocoder.npz"))
    return {"acoustic": load_slim_npz(str(zd / "acoustic.npz"))["acoustic"],
            "refiner": load_slim_npz(str(zd / "refiner.npz"))["refiner"],
            "generator": voc["gen_ema"], "gst": voc["gst"],
            "vocoder_meta": voc.get("_meta", {})}


def load_pipeline(cfg: Optional[TTSXConfig] = None,
                  zoo_dir: Optional[str] = None, device="cuda"):
    """(TTSPipeline on ``device``, vocoder export meta) from the zoo."""
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.weights import load_flax
    dev = resolve_device(device)
    if cfg is None:
        cfg = zoo_cfg(True, zoo_info(zoo_dir).get("vocoder_overrides"))
    trees = load_zoo_trees(zoo_dir)
    pipe = TTSPipeline(cfg)
    for name in ("acoustic", "refiner", "generator", "gst"):
        load_flax(getattr(pipe, name), trees.pop(name))
    return pipe.to(dev), trees["vocoder_meta"]


def serve_from_zoo(zoo_dir: Optional[str] = None,
                   cfg: Optional[TTSXConfig] = None, device="cuda",
                   **server_kw):
    """A ready ``SynthesisServer`` on the zoo model, its options
    (``bf16``, default on, ``max_batch``, ``frames``, ...) passed through
    with the server's defaults, which are the reference's. A scale_cond
    vocoder gets the train-corpus ``mel_scale_mean`` from its export meta
    as ``scale_stats`` unless the caller passes them."""
    from ttsx_torch.serve import SynthesisServer
    pipe, meta = load_pipeline(cfg, zoo_dir, device)
    if "scale_stats" not in server_kw and "mel_scale_mean" in meta:
        server_kw["scale_stats"] = np.asarray(meta["mel_scale_mean"])
    return SynthesisServer(pipe, device=device, **server_kw)
