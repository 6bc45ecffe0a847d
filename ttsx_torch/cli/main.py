"""The port's command lines (``ttsx/cli/main.py``): ``main_train``, the
acoustic, refiner and vocoder GAN trainer on a wav tree or on synthetic
batches, ``main_synth``, text -> waveform, ``main_diarize``, the
speaker diarizer, and ``main_observer``, the observer ingestion
pipeline.

    python -m ttsx_torch.cli.main --data-root DIR [--max-steps N]
        [--config cfg.json] [--output-dir out] [--device cuda|cpu]
        [--blocks acoustic,refiner,vocoder] [--resume]

With ``--data-root`` the path is: ``TTSDataset`` -> ``TTSCollator`` (mel
through K3 and f0 / energy on ``--device``) -> ``collator_to_trainer_batch``
-> ``UnifiedTrainer``. Training batches draw ``batch_size`` items with
replacement from a generator seeded with ``TrainConfig.seed``; the
validation set is one batch of the first items, collated without
augmentation. ``--synthetic`` (or no data root)
trains on synthetic batches of 2 x 16 frames. The run ends with one
validation pass; ``train_log.jsonl`` and ``step_times.json`` go to
``--output-dir`` and the checkpoints (``best``, ``last`` every
``checkpoint_freq`` steps, ``final``) to ``--output-dir``/checkpoints.
``--resume`` restores ``last`` from there first and trains on to
``--max-steps`` on the batches that follow the ones the stopped run's
steps took (the checkpoint's ``extra["batches"]``, micro-batches
included): the index draws and the collator's ``batch_idx``, or the
synthetic batches' seeds, go on where that run left them, so a resumed
run sees the batches of an uninterrupted one (the reference starts its
stream again from the seed). The vocoder trains on each step's
collated wav (cut to whole generator hops:
``train.blocks.match_lengths``).

    python -m ttsx_torch.cli.synth [--zoo [DIR]] [--sde] [--text T]
        [--frames N] [--out synth.wav] [--seed S] [--device cuda|cpu]
        [--config cfg.json] [--checkpoint DIR]

``main_synth`` (``python -m ttsx_torch.cli.synth``, as the reference's
``ttsx-synth``) synthesizes ``--frames`` mel frames of ``--text`` with the
zoo model (``--zoo``) or a fresh init of ``--config`` (default
``TTSXConfig()``) seeded by ``--seed``, single-pass or with ``--sde``
(noise from a generator on the device seeded by ``--seed``), writes the
wav and prints ``{"wav", "samples", "seconds"}``. ``--checkpoint DIR``
first loads the ``best`` checkpoint of a ``main_train`` run (DIR is its
checkpoint directory) into the pipeline: the acoustic and refiner
models, the generator's EMA and the GST, each stage the run trained,
whole; the JSON line then also names the tag, step and stages. The
reference restores the engine's block states into the pipeline's
parameter tree, a different tree, which raises. ``--output-dir`` is
accepted as the reference's common flag and, as there, not used by
synthesis.

    python -m ttsx_torch.cli.diarize WAV [WAV ...] [--output-dir out]
        [--streaming] [--eval REF.rttm] [--snapshot mem.pkl]
        [--workers N] [--device cuda|cpu]

``main_diarize`` (as the reference's ``ttsx-diarize``) builds the
reference CLI's controller (default ``DiarizerController``: an untrained
slice encoder, modularity clustering) on ``--device``, with a ReID
memory loaded from and saved back to ``--snapshot``, and diarizes one
wav into ``--output-dir`` or several in batch mode (``--workers``
threads, each job under ``--output-dir``/<job id>). ``--eval`` prints
the DER and purity of the first wav's RTTM against a reference RTTM (in
batch mode the RTTM in that job's directory; the reference reads the
top directory there, where batch mode writes none). It returns 0 when a
job succeeded.

    python -m ttsx_torch.cli.observer (--job WAV | --watch DIR)
        [--output-dir out] [--git-repo REPO] [--config FILE]
        [--device cuda|cpu]

``main_observer`` (as the reference's ``ttsx-observer``) builds the
default ``ObserverPipeline`` on ``--device`` (an untrained slice
encoder, the energy-VAD transcriber, the DSP prosody trend) and runs one
job on ``--job`` into ``--output-dir``, printing its summary (it returns
0 unless the job's status is ``failed``; a ``partial-failure`` returns 0,
as in the reference), or watches ``--watch`` for ``<name>.wav.ready``
markers, each job under ``--output-dir``/<name>, until SIGINT or SIGTERM
(the reference's loop waits for a ``KeyboardInterrupt`` that its own
signal handler keeps from coming, so it never returns). ``--config`` is
parsed and not used, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


def data_streams(cfg, data_root: str, device, start: int = 0):
    """(train iterator, validation list) over ``data_root``; each training
    batch carries its host ``collate_time`` in seconds. The iterator
    begins at batch ``start`` of the stream: the batches before it are
    drawn but not collated, only their wavs' augmentations replayed into
    the collator's feature cache (``TTSCollator.replay``), which keeps a
    wav's first augmentation."""
    from ttsx_torch.data.adapters import collator_to_trainer_batch
    from ttsx_torch.data.collate import CollatorConfig, TTSCollator
    from ttsx_torch.data.dataset import TTSDataset, TTSDatasetConfig
    ds = TTSDataset(TTSDatasetConfig(audio_root=data_root, audio=cfg.audio,
                                     text_emb_dim=cfg.acoustic.text_emb_dim))
    if not len(ds):
        raise ValueError(f"no <speaker>/<domain>/<style>/*.wav under "
                         f"{data_root}")
    coll = TTSCollator(CollatorConfig(audio=cfg.audio), device=device)
    plain = TTSCollator(CollatorConfig(audio=cfg.audio, augment=False,
                                       cache_features=False), device=device)
    bs = cfg.train.batch_size

    def train() -> Iterator[Dict]:
        rng = np.random.default_rng(cfg.train.seed)
        for bi in range(start):
            idx = rng.choice(len(ds), bs)
            if coll.cfg.cache_features and coll.cfg.augment:
                coll.replay([ds[int(i)] for i in idx if not coll.cached(
                    ds.items[int(i)]["wav_path"])], batch_idx=bi)
        bi = start
        while True:
            idx = rng.choice(len(ds), bs)
            raw = coll([ds[int(i)] for i in idx], batch_idx=bi)
            bi += 1
            batch = collator_to_trainer_batch(raw, cfg)
            batch["collate_time"] = raw["collate_time"]
            yield batch

    items = [ds[j % len(ds)] for j in range(bs)]
    return train(), [collator_to_trainer_batch(plain(items), cfg)]


def main_train(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-train")
    p.add_argument("--config", help="TTSXConfig JSON (reference field names)")
    p.add_argument("--data-root")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic batches (smoke mode)")
    p.add_argument("--max-steps", type=int)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device", default="cuda")
    p.add_argument("--blocks", default="acoustic,refiner,vocoder")
    p.add_argument("--resume", action="store_true",
                   help="restore the 'last' checkpoint of --output-dir")
    args = p.parse_args(argv)

    from ttsx_torch.core.config import TTSXConfig, from_dict
    from ttsx_torch.core.device import resolve_device, set_f32_numerics
    from ttsx_torch.train.callbacks import JSONLLogger, StepTimeArtifact
    from ttsx_torch.train.engine import UnifiedTrainer
    blocks = [b.strip() for b in args.blocks.split(",") if b.strip()]
    cfg = (from_dict(TTSXConfig, json.loads(Path(args.config).read_text()))
           if args.config else TTSXConfig())
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()

    out = Path(args.output_dir)
    start = 0
    if args.resume:
        from ttsx_torch.train.checkpoint import read_meta
        meta = read_meta(str(out / "checkpoints"), "last") or {}
        start = int(meta.get("extra", {}).get("batches", 0))
    if args.synthetic or not args.data_root:
        from ttsx_torch.data.synthetic import synthetic_batch, synthetic_stream
        steps = args.max_steps or 10
        stream = synthetic_stream(cfg, batch=2, frames=16,
                                  n=steps * cfg.train.grad_accum_steps,
                                  start=start)
        val = [synthetic_batch(cfg, batch=2, frames=16, seed=10_000)]
    else:
        stream, val = data_streams(cfg, args.data_root, device, start)
    trainer = UnifiedTrainer(
        cfg, stream, val, blocks=blocks, device=device,
        callbacks=[JSONLLogger(str(out / "train_log.jsonl"), every=1),
                   StepTimeArtifact(str(out / "step_times.json"))],
        checkpoint_dir=str(out / "checkpoints"))
    if args.resume:
        trainer.restore_checkpoint("last")
    state = trainer.train(max_steps=args.max_steps)
    val_metrics = trainer.validate()
    print(json.dumps({"global_step": state.global_step,
                      "val_l1": val_metrics.get("val_l1"),
                      "noise_scale": state.noise_scale,
                      "l1_weight": state.l1_weight}))
    return 0


def main_synth(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-synth")
    p.add_argument("--text", default="hello world")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--checkpoint", metavar="DIR",
                   help="load the 'best' checkpoint of a training run")
    p.add_argument("--config", help="TTSXConfig JSON of the fresh init")
    p.add_argument("--zoo", nargs="?", const="", metavar="DIR",
                   help="load the git-tracked pretrained zoo exports "
                        "(default dir: eval_results/zoo) with its config")
    p.add_argument("--sde", action="store_true")
    p.add_argument("--out", default="synth.wav")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from ttsx_torch.core.config import TTSXConfig, from_dict
    from ttsx_torch.core.device import resolve_device, set_f32_numerics
    from ttsx_torch.data.dataset import TextEncoder, write_wav
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    if args.zoo is not None:
        from ttsx_torch.zoo import load_pipeline
        pipe, _ = load_pipeline(zoo_dir=args.zoo or None, device=device)
    else:
        from ttsx_torch.models.pipeline import TTSPipeline
        from ttsx_torch.nn.init import fresh_init_
        cfg = (from_dict(TTSXConfig, json.loads(Path(args.config).read_text()))
               if args.config else TTSXConfig())
        pipe = fresh_init_(TTSPipeline(cfg),
                           torch.Generator().manual_seed(args.seed)).to(device)
    loaded = {}
    if args.checkpoint:
        from ttsx_torch.train.checkpoint import load_pipeline_checkpoint
        loaded = {"checkpoint": load_pipeline_checkpoint(pipe,
                                                         args.checkpoint)}
    cfg = pipe.cfg
    ac = cfg.acoustic
    T = args.frames
    emb = torch.as_tensor(TextEncoder(ac.text_emb_dim)(args.text),
                          device=device)
    text_emb = emb[None, None, :].expand(1, T, ac.text_emb_dim)
    prosody = torch.zeros(1, T, ac.cond_dim, device=device)
    emo = torch.full((1, ac.emotion_dim), 1 / ac.emotion_dim, device=device)
    spk = torch.zeros(1, ac.speaker_dim, device=device)
    sid = torch.zeros(1, dtype=torch.long, device=device)
    gen = torch.Generator(device).manual_seed(args.seed)
    wav = pipe.synthesize(text_emb, prosody, emo, spk, sid, use_sde=args.sde,
                          generator=gen).wav
    write_wav(args.out, wav[0, :, 0].cpu().numpy(), cfg.vocoder.sr)
    print(json.dumps({"wav": args.out, "samples": int(wav.shape[1]),
                      "seconds": wav.shape[1] / cfg.vocoder.sr, **loaded}))
    return 0


def main_observer(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-observer")
    p.add_argument("--job", help="process a single wav")
    p.add_argument("--watch", help="watch a directory for *.ready markers")
    p.add_argument("--config", help="YAML/JSON config file (not used)")
    p.add_argument("--git-repo", help="repo for artifact sync")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ttsx_torch.core.device import resolve_device, set_f32_numerics
    from ttsx_torch.pipeline import ObserverPipeline, watch
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    if args.job:
        pipe = ObserverPipeline(git_repo=args.git_repo, device=device)
        summary = pipe.run_job(args.job, args.output_dir)
        print(json.dumps(summary, indent=1))
        return 0 if summary["status"] != "failed" else 1
    if args.watch:
        watcher, worker, q = watch(args.watch, args.output_dir,
                                   git_repo=args.git_repo, device=device)
        print(f"watching {args.watch} (ctrl-c to stop)", flush=True)
        watcher.wait()      # until SIGINT / SIGTERM stops the watcher
        worker.stop()
        return 0
    p.print_help()
    return 2


def main_diarize(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-diarize")
    p.add_argument("wavs", nargs="+")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--eval", dest="eval_rttm",
                   help="reference RTTM for DER/purity")
    p.add_argument("--snapshot", help="ReID memory snapshot to load/save")
    p.add_argument("--workers", type=int, default=4,
                   help="thread-pool size for batch mode")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import logging
    from ttsx_torch.core.device import resolve_device, set_f32_numerics
    from ttsx_torch.pipeline.diarizer import DiarizerController, ReIDMemory
    from ttsx_torch.pipeline.diarizer.controller import job_ids
    from ttsx_torch.utils.logs import attach_rotating_handler
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_f32_numerics()
    attach_rotating_handler(logging.getLogger("ttsx_torch.diarizer"),
                            Path(args.output_dir) / "diarizer.log")
    memory = ReIDMemory()
    if args.snapshot and Path(args.snapshot).exists():
        memory.load_snapshot(args.snapshot)
    ctl = DiarizerController(memory=memory, device=device)
    batch = len(args.wavs) > 1
    if not batch:
        res = ctl.diarize_single(args.wavs[0], args.output_dir,
                                 streaming=args.streaming)
        ok = bool(res)
    else:
        res = ctl.diarize_batch(args.wavs, args.output_dir,
                                workers=args.workers)
        ok = any(res.values())
    if args.snapshot:
        memory.snapshot(args.snapshot)
    if args.eval_rttm:
        job_dir = Path(args.output_dir)
        if batch:
            job_dir = job_dir / job_ids(args.wavs)[0]
        hyp = job_dir / f"{Path(args.wavs[0]).stem}.rttm"
        print(json.dumps(ctl.evaluate(args.eval_rttm, str(hyp))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main_train())
