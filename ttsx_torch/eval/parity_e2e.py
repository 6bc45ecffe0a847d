"""The text -> waveform chain (``ttsx/eval/parity_e2e.py``): the trained
acoustic -> trained refiner -> trained vocoder on held-out text, read as
waveform quality (``_wav_quality``) for both refiner paths, the
deterministic ``val_step`` and the 8-step Euler-Maruyama ``sde_sample``,
beside copy-synthesis.

``e2e_parity(zoo_dir=)`` exports the three trained stages as slim npz
files with ``zoo.json``, the layout ``ttsx_torch.zoo`` (and the
reference's ``ttsx.zoo``) loads; ``stage_ckpt_dir`` makes the acoustic
and refiner legs resumable, ``vocoder_save_dir`` the vocoder's.

The SDE noise is ``torch.Generator`` draws seeded ``seed + i`` for the
batch at row i, as the reference keys its draws; JAX's stream cannot be
reproduced.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ttsx_torch.eval.parity import (_refiner_steps, _tts_cfg,
                                    acoustic_parity)
from ttsx_torch.eval.parity_common import (_acoustic_preds, _model_batch,
                                           _wav_quality)
from ttsx_torch.eval.parity_vocoder import _synth_wav, vocoder_parity


@torch.no_grad()
def _refine(r_block, ev_model: Dict, ev_pred: np.ndarray, batch: int,
            use_sde: bool, seed: int) -> np.ndarray:
    """Batched refiner inference: the deterministic ``val_step`` or
    ``sde_sample``."""
    from ttsx_torch.models.refiner import sde_sample
    from ttsx_torch.train.blocks import as_tensors

    dev = r_block.device
    outs = []
    for i in range(0, len(ev_pred), batch):
        mb = {k: v[i:i + batch] for k, v in ev_model.items()}
        pred = torch.as_tensor(ev_pred[i:i + batch], device=dev)
        if use_sde:
            b = as_tensors(mb, dev)
            out = sde_sample(r_block.model, pred, b["prosody"],
                             b["style_id"], b["text_emb"],
                             generator=torch.Generator(dev).manual_seed(
                                 seed + i))
        else:
            out = r_block.val_step(mb, pred)["mel_ref"]
        outs.append(out.cpu().numpy())
    return np.concatenate(outs)


def _export_zoo(zoo_dir: str, a_block, r_block, v_block, tr: Dict,
                corpus, steps: Dict, vocoder_overrides, seed: int):
    """acoustic.npz, refiner.npz, vocoder.npz (EMA generator + GST, with
    the effective step count and the training set's mean scale vector)
    and zoo.json, merged into an existing one (the stage-1/2 exports write
    their own entries)."""
    from ttsx_torch.train.slim_export import save_slim, save_vocoder_slim
    zd = Path(zoo_dir)
    zd.mkdir(parents=True, exist_ok=True)
    save_slim(str(zd / "acoustic.npz"), {"acoustic": a_block.model})
    save_slim(str(zd / "refiner.npz"), {"refiner": r_block.model})
    vmeta = {"steps": steps["vocoder"]}
    if "mel_scale" in tr:
        # the serving default of scale_cond / scale_gain generators
        vmeta["mel_scale_mean"] = tr["mel_scale"].mean(axis=0)
    save_vocoder_slim(str(zd / "vocoder.npz"), v_block, meta=vmeta)
    zj = zd / "zoo.json"
    z = json.loads(zj.read_text()) if zj.exists() else {}
    z.setdefault("steps", {}).update(steps)
    z.update(config="ttsx.eval.parity._tts_cfg()",
             vocoder_overrides=vocoder_overrides or {},
             corpus=f"{type(corpus).__name__}"
                    f"(n_speakers={corpus.n_speakers})",
             seed=seed)
    zj.write_text(json.dumps(z, indent=1))


def e2e_parity(acoustic_steps: int = 4000, refiner_steps: int = 2400,
               vocoder_steps: int = 2000, frames: int = 128,
               batch: int = 8, seed: int = 0,
               vocoder_save_dir: Optional[str] = None,
               vocoder_overrides: Optional[Dict] = None,
               zoo_dir: Optional[str] = None,
               corpus: str = "tone",
               stage_ckpt_dir: Optional[str] = None,
               device="cuda") -> Dict:
    """Text -> mel0 -> mel_ref -> waveform with every stage trained, on
    held-out utterances (see the module docstring)."""
    from ttsx_torch.train.blocks import RefinerBlock
    from ttsx_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)

    corpus_kind = corpus
    base = acoustic_parity(steps=acoustic_steps, batch=16, frames=frames,
                           seed=seed, return_states=True, corpus=corpus,
                           save_dir=stage_ckpt_dir, device=device)
    a_block = base["_block"]
    corpus, tr, ev = base["_data"]
    hop = int(np.prod(base["_cfg"].vocoder.upsample_factors))
    tr_pred, tr_cut = _acoustic_preds(a_block, tr, batch)
    ev_pred, ev_cut = _acoustic_preds(a_block, ev, batch)

    # the refiner trained on the acoustic's own outputs (levels 2)
    r_block = RefinerBlock(_tts_cfg(), a_block.device, seed)
    r_start = 0
    if stage_ckpt_dir is not None:
        got = restore_checkpoint(stage_ckpt_dir, "refiner_e2e",
                                 r_block.state_dict())
        if got is not None:
            states, r_start, _ = got
            r_block.load_state_dict(states)
            r_start = min(int(r_start), refiner_steps)

    def save(it):
        done = r_start + it + 1
        if (stage_ckpt_dir is not None and done < refiner_steps
                and done % 800 == 0):
            save_checkpoint(stage_ckpt_dir, "refiner_e2e",
                            r_block.state_dict(), done)

    _refiner_steps(r_block, _model_batch(tr_cut), tr_pred, batch,
                   np.random.default_rng(seed), refiner_steps - r_start,
                   on_step=save)
    if stage_ckpt_dir is not None and refiner_steps > r_start:
        save_checkpoint(stage_ckpt_dir, "refiner_e2e", r_block.state_dict(),
                        refiner_steps)
    ev_model = _model_batch(ev_cut)
    mel_ref = _refine(r_block, ev_model, ev_pred, batch, False, seed)
    mel_sde = _refine(r_block, ev_model, ev_pred, batch, True, seed)

    # the vocoder trained on ground-truth mels of the same corpus (or a
    # previous vocoder_quality run's checkpoint, with vocoder_save_dir)
    voc = vocoder_parity(steps=vocoder_steps, frames=64, batch=4,
                         n_speakers=corpus.n_speakers, seed=seed,
                         return_states=True, save_dir=vocoder_save_dir,
                         vocoder_overrides=vocoder_overrides,
                         corpus=corpus_kind, device=a_block.device)
    v_block = voc.pop("_block")
    voc.pop("_corpus", None)
    steps = {"acoustic": acoustic_steps, "refiner": refiner_steps,
             "vocoder": int(voc.get("effective_steps", vocoder_steps))}
    if zoo_dir is not None:
        _export_zoo(zoo_dir, a_block, r_block, v_block, tr, corpus,
                    steps, vocoder_overrides, seed)

    # text -> wav sees the training set's mean scale vector, never the
    # target utterance's stats; copy-synthesis keeps its own
    scale_default = tr["mel_scale"].mean(axis=0)
    wav_real = ev_cut["wav"][:, :frames * hop, 0]
    syn = lambda mel, ema, scale=None: _synth_wav(
        v_block, mel, ev_model, 4, use_ema=ema, scale_override=scale)
    wav_e2e = syn(mel_ref, False, scale_default)
    wav_copy = syn(ev_model["mel"], False)
    # the EMA generator is the better read once steps >> 1 / (1 - decay)
    wav_e2e_ema = syn(mel_ref, True, scale_default)
    wav_sde_ema = syn(mel_sde, True, scale_default)
    n = len(wav_e2e)
    q = lambda w: _wav_quality(w, wav_real[:len(w)], a_block.device)
    return {"exp": "e2e",
            "acoustic_mcd_db": base["mcd_db"],
            "corpus": corpus_kind,
            "copy_synthesis": q(wav_copy),
            "text_to_wav": q(wav_e2e),
            "text_to_wav_ema": q(wav_e2e_ema),
            "text_to_wav_sde_ema": q(wav_sde_ema),
            "eval_utts": int(n),
            "steps": steps,
            "vocoder": voc}
