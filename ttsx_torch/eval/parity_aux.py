"""Parity harness part 2 (``ttsx/eval/parity_aux.py``): the vocoder GAN
smoke, the easy diarizer DER, the experiment table and the CLI.

    python -m ttsx_torch.eval.parity_aux --exp NAME|all [--out FILE] [--cpu]
    ttsx-torch-parity --exp NAME|all ...

runs on the card unless ``--cpu`` is given (without a card it raises).
``all`` is the standard set; ``vocoder_quality``, ``e2e`` and
``diarizer_hard`` run only by name. Results merge into ``--out``, by
default ``eval_results_torch/parity.json`` under the working directory
(the reference's default, ``eval_results/parity.json``, is the
reference's own record).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ttsx_torch.eval.parity import (_tts_cfg, acoustic_parity,
                                    refiner_parity)
from ttsx_torch.eval.parity_common import (AUDIO, _batch_sampler,
                                           _model_batch, _normalize_mels,
                                           experiment_device, make_corpus)
from ttsx_torch.eval.parity_diar import _train_slice_encoder

DEFAULT_OUT = "eval_results_torch/parity.json"


def vocoder_gan_smoke(steps: int = 500, frames: int = 64, batch: int = 4,
                      n_speakers: int = 4, seed: int = 0,
                      corpus: str = "tone", device="cuda") -> Dict:
    """The GAN at the reference's discriminators: the D / G loss tails of
    the last 100 steps, R1 on the steps that take it, finiteness, and the
    discriminators' parameter count."""
    from ttsx_torch.train.blocks import VocoderBlock

    dev = experiment_device(device)
    cfg = _tts_cfg()
    corpus = make_corpus(corpus, n_speakers=n_speakers, audio=AUDIO,
                         seed=seed)
    # the normalised mel, the space the generator sees
    feats = _model_batch(_normalize_mels(corpus.features(
        corpus.utterances(8, frames, seed=seed), device=dev)))
    # the wav is frames x hop samples, the generator's contract
    hop = int(np.prod(cfg.vocoder.upsample_factors))
    T = feats["mel"].shape[1]
    feats["wav"] = feats["wav"][:, :T * hop]
    block = VocoderBlock(cfg, dev, seed)
    sampler = _batch_sampler(feats, batch, seed)
    next(sampler)   # the reference's init batch: the steps take the next
    d_hist, g_hist, r1_hist = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        mb = next(sampler)
        dm = block.disc_step(mb)
        gm = block.gen_step(mb)
        d_hist.append(float(dm["d_loss"]))
        r1_hist.append(float(dm["r1"]))
        g_hist.append(float(gm["g_loss"]))
    train_s = time.perf_counter() - t0
    tail_d = np.asarray(d_hist[-100:])
    tail_g = np.asarray(g_hist[-100:])
    r1_on = [r for r in r1_hist[-100:] if r > 0.0]
    n_params = sum(p.numel() for m in (block.mpd, block.msd, block.mbd)
                   for p in m.parameters())
    return {"exp": "vocoder_gan_smoke", "steps": steps,
            "d_loss_tail_mean": float(tail_d.mean()),
            "d_loss_tail_std": float(tail_d.std()),
            "g_loss_tail_mean": float(tail_g.mean()),
            "g_loss_tail_std": float(tail_g.std()),
            "r1_tail_mean_on_r1_steps": float(np.mean(r1_on)) if r1_on
            else 0.0,
            "stable": bool(np.isfinite(d_hist).all()
                           and np.isfinite(g_hist).all()),
            "disc_params": n_params, "train_seconds": train_s}


def diarizer_parity(n_speakers: int = 3, n_turns: int = 12,
                    seed: int = 0, out_dir: Optional[str] = None,
                    trained: bool = True, train_steps: int = 400,
                    corpus: str = "tone", device="cuda") -> Dict:
    """DER of a clean alternating dialogue, untrained and with a trained
    slice encoder."""
    import tempfile

    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.eval.metrics import diarization_error_rate
    from ttsx_torch.pipeline.diarizer.controller import DiarizerController
    from ttsx_torch.pipeline.diarizer.embedding import SliceEmbedder

    dev = experiment_device(device)
    corpus = make_corpus(corpus, n_speakers=max(n_speakers, 4),
                         audio=AUDIO, seed=seed)
    wav, truth = corpus.dialogue(list(range(n_speakers)), n_turns,
                                 seed=seed)
    out = Path(out_dir or tempfile.mkdtemp())
    wav_path = out / "dialogue.wav"
    write_wav(wav_path, wav.astype(np.float32), AUDIO.sample_rate)

    def run(embedder, tag):
        ctl = DiarizerController(AUDIO, embedder=embedder,
                                 min_dur=0.8, max_dur=3.0, device=dev)
        res = ctl.diarize_single(str(wav_path), str(out / f"diar_{tag}"))
        hyp = [(s, e, spk) for (s, e), spk in
               zip(res.get("slices", []), res.get("speakers", []))]
        return {"der": float(diarization_error_rate(truth, hyp)),
                "der_collar_250ms": float(diarization_error_rate(
                    truth, hyp, collar=0.25)),
                "n_hyp_speakers": len(set(res.get("speakers", []))),
                "n_slices": len(res.get("slices", []))}

    result: Dict = {"exp": "diarizer", "n_true_speakers": n_speakers,
                    "n_turns": n_turns,
                    "untrained": run(None, "untrained")}
    if trained:
        cfg, params = _train_slice_encoder(corpus, steps=train_steps,
                                           seed=seed, device=dev)
        emb = SliceEmbedder(AUDIO, cfg=cfg, params=params, device=dev)
        result["trained"] = run(emb, "trained")
        result["train_steps"] = train_steps
    return result


def _lazy(name, module="ttsx_torch.eval.parity_e2e"):
    def run(**kw):
        import importlib
        return getattr(importlib.import_module(module), name)(**kw)
    return run


EXPERIMENTS = {
    "refenc": _lazy("refenc_parity", "ttsx_torch.eval.parity_refenc"),
    "prosody": _lazy("prosody_parity", "ttsx_torch.eval.parity_prosody"),
    "acoustic": acoustic_parity,
    "refiner": refiner_parity,
    "vocoder": vocoder_gan_smoke,
    "vocoder_quality": _lazy("vocoder_parity",
                             "ttsx_torch.eval.parity_vocoder"),
    "e2e": _lazy("e2e_parity"),
    "diarizer": diarizer_parity,
    "diarizer_hard": _lazy("diarizer_hard", "ttsx_torch.eval.parity_diar"),
}
# the chained runs (a full GAN, three stages, the hard stream) run only
# by name
HEAVY = ("vocoder_quality", "e2e", "diarizer_hard")


def _json_or_str(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def main(argv=None):
    p = argparse.ArgumentParser("ttsx-torch-parity")
    p.add_argument("--exp", default="all",
                   choices=[*EXPERIMENTS, "all"])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    p.add_argument("--steps", type=int, default=None,
                   help="cumulative step target for the experiment")
    p.add_argument("--save-dir", default=None,
                   help="checkpoint dir to resume/extend (vocoder_quality)")
    p.add_argument("--key", default=None,
                   help="record the result under this key instead of the "
                        "experiment's name (e.g. vocoder_quality_84k)")
    p.add_argument("--override", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="VocoderConfig field override for ablation legs, "
                        "e.g. --override lambda_energy=1.0 (repeatable)")
    p.add_argument("--arg", action="append", default=[],
                   metavar="K=V",
                   help="extra experiment kwarg (JSON value), e.g. "
                        "--arg utts_train=64 (repeatable)")
    args = p.parse_args(argv)
    names = ([n for n in EXPERIMENTS if n not in HEAVY]
             if args.exp == "all" else [args.exp])
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}
    kw = {}
    if args.steps is not None:
        kw["steps"] = args.steps
    if args.save_dir is not None:
        kw["save_dir"] = args.save_dir
    if args.override:
        kw["vocoder_overrides"] = {
            field: _json_or_str(raw) for field, _, raw in
            (item.partition("=") for item in args.override)}
    for item in args.arg:
        k, _, raw = item.partition("=")
        kw[k] = _json_or_str(raw)
    if kw and (len(names) != 1 or args.exp == "all"):
        p.error("--steps/--save-dir/--override/--arg need a single --exp")
    device = "cpu" if args.cpu else "cuda"
    for name in names:
        r = EXPERIMENTS[name](**kw, device=device)
        r = {k: v for k, v in r.items() if not k.startswith("_")}
        if name == "refiner" and "acoustic" in r:
            # the refiner run embeds a full acoustic experiment
            results["acoustic"] = r.pop("acoustic")
        if "vocoder_overrides" in kw:
            r["vocoder_overrides"] = kw["vocoder_overrides"]
        if args.arg:
            r["cli_args"] = {k: kw[k] for k in
                             (i.partition("=")[0] for i in args.arg)}
        results[args.key or name] = r
        print(json.dumps({args.key or name: r}))
        out_path.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
