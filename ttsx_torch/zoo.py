"""The checked-in trained zoo (``eval_results/zoo``), loaded by the port.

``load_pipeline`` reads ``acoustic.npz``, ``refiner.npz`` and
``vocoder.npz`` (EMA generator + GST) with numpy alone, converts each
once into the port's modules, and moves them to ``device``: no JAX is
needed. The config is ``zoo_cfg()``: the reference's ``_tts_cfg()`` with
zoo.json's vocoder overrides and, by default, both CUDA kernel flags on
(the flags change no parameter). Every stage must be present and load
whole; a missing file or key raises.

``load_refenc`` and ``load_prosody`` rebuild stages 1 and 2 from
``refenc.npz`` and ``prosody.npz`` with the config each was trained
with (the export's ``_meta`` and the training harness's settings, on
``AUDIO``, the unnormalized log-mel) and return a trainer holding the
weights and its module, on ``device``. ``load_refenc`` takes the loss
head (ArcFace or GE2E) from the leaves the export holds; the reference
takes the config's default, so a GE2E export does not load there.

``load_diar_encoder`` rebuilds the diarizer's slice encoder from
``diar_encoder.npz`` (ECAPA width, speaker_dim and speaker count from
its ``_meta``, on ``AUDIO``) and returns a ready ``SliceEmbedder`` on
``device``. Like the other loaders it raises on a missing export (the
reference returns None).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ttsx_torch.core.config import (AudioConfig, ProsodyConfig,
                                    RefEncConfig, S4Config, TTSXConfig,
                                    zoo_cfg)
from ttsx_torch.core.device import resolve_device

DEFAULT_ZOO = Path(__file__).resolve().parent.parent / "eval_results/zoo"
# the frontend of the speaker and prosody exports' training harness
AUDIO = AudioConfig(mel_normalize=False)


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


def _export(zoo_dir: Optional[str], name: str):
    """(the export's tree under its own name, its ``_meta``)."""
    from ttsx_torch.weights import load_slim_npz
    path = (Path(zoo_dir) if zoo_dir else DEFAULT_ZOO) / f"{name}.npz"
    trees = load_slim_npz(str(path))
    return trees[name], trees.get("_meta", {})


def load_refenc(zoo_dir: Optional[str] = None, device="cuda"):
    """(``RefEncTrainer`` with the trained encoder and loss head, its
    ``ReferenceEncoder``) from ``refenc.npz``: ``num_speakers`` from the
    export's meta, the head from its leaves."""
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.weights import from_flax_params
    tree, meta = _export(zoo_dir, "refenc")
    cfg = RefEncConfig(audio=AUDIO,
                       num_speakers=int(meta.get("num_speakers", 12)),
                       loss="ge2e" if "ge2e_w" in tree else "arcface")
    trainer = RefEncTrainer(cfg, device)
    trainer.params.load_state_dict(from_flax_params(trainer.params, tree))
    return trainer, trainer.model


def load_prosody(zoo_dir: Optional[str] = None, device="cuda"):
    """(``ProsodyTrainer`` with the trained predictor, its
    ``ProsodyPredictor``) from ``prosody.npz``: ``cond_dim`` and
    ``n_layers`` from the export's meta, the S4 layers non-causal with
    4 heads, ``l_max`` 1024 and 4 norm groups, the MFCC weight 0.05, as
    the training harness set them."""
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    from ttsx_torch.weights import load_flax
    tree, meta = _export(zoo_dir, "prosody")
    cfg = ProsodyConfig(
        audio=AUDIO, cond_dim=int(meta.get("cond_dim", 256)),
        n_layers=int(meta.get("n_layers", 4)), mfcc_weight=0.05,
        s4=S4Config(heads=4, l_max=1024, causal=False, norm_groups=4,
                    dropout=0.1))
    trainer = ProsodyTrainer(cfg, device=device)
    load_flax(trainer.model, tree)
    return trainer, trainer.model


def load_diar_encoder(zoo_dir: Optional[str] = None, device="cuda"):
    """The trained hard-diarizer slice encoder from ``diar_encoder.npz``
    -> a ``SliceEmbedder`` on ``device`` holding it (the export's tree is
    the trainer's ``model`` entry, saved under the name ``refenc``)."""
    from ttsx_torch.pipeline.diarizer.embedding import SliceEmbedder
    from ttsx_torch.weights import load_slim_npz
    path = (Path(zoo_dir) if zoo_dir else DEFAULT_ZOO) / "diar_encoder.npz"
    if not path.exists():
        raise FileNotFoundError(f"no diarizer encoder export at {path}")
    trees = load_slim_npz(str(path))
    meta = trees.get("_meta", {})
    cfg = RefEncConfig(
        audio=AUDIO,
        speaker_dim=int(meta.get("speaker_dim", 192)),
        ecapa_channels=int(meta.get("ecapa_channels", 256)),
        num_speakers=int(meta.get("num_speakers", 6)))
    emb = SliceEmbedder(AUDIO, cfg=cfg, params=trees["refenc"],
                        device=device)
    emb._ensure_model()     # load now: a bad export raises here
    return emb
