"""The port's command lines (``ttsx/cli/main.py``): ``main_train``, the
acoustic, refiner and vocoder GAN trainer on a wav tree or on synthetic
batches, and ``main_synth``, text -> waveform.

    python -m ttsx_torch.cli.main --data-root DIR [--max-steps N]
        [--config cfg.json] [--output-dir out] [--device cuda|cpu]
        [--blocks acoustic,refiner,vocoder]

With ``--data-root`` the path is: ``TTSDataset`` -> ``TTSCollator`` (mel
through K3 and f0 / energy on ``--device``) -> ``collator_to_trainer_batch``
-> ``UnifiedTrainer``. Training batches draw ``batch_size`` items with
replacement from a generator seeded with ``TrainConfig.seed``; the
validation set is one batch of the first items, collated without
augmentation. ``--synthetic`` (or no data root)
trains on synthetic batches of 2 x 16 frames. The run ends with one
validation pass; ``train_log.jsonl`` and ``step_times.json`` go to
``--output-dir``. The vocoder trains on each step's collated wav (cut to
whole generator hops: ``train.blocks.match_lengths``). Checkpoints are
not ported yet.

    python -m ttsx_torch.cli.synth [--zoo [DIR]] [--sde] [--text T]
        [--frames N] [--out synth.wav] [--seed S] [--device cuda|cpu]

``main_synth`` (``python -m ttsx_torch.cli.synth``, as the reference's
``ttsx-synth``) synthesizes ``--frames`` mel frames of ``--text`` with the
zoo model (``--zoo``) or a fresh init of ``TTSXConfig()`` seeded by
``--seed``, single-pass or with ``--sde`` (noise from a generator on the
device seeded by ``--seed``), writes the wav and prints ``{"wav", "samples", "seconds"}``. ``--checkpoint`` raises
until checkpoints are ported; ``--output-dir`` is accepted as the
reference's common flag and, as there, not used by synthesis.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


def data_streams(cfg, data_root: str, device):
    """(train iterator, validation list) over ``data_root``; each training
    batch carries its host ``collate_time`` in seconds."""
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
        bi = 0
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

    if args.synthetic or not args.data_root:
        from ttsx_torch.data.synthetic import synthetic_batch, synthetic_stream
        steps = args.max_steps or 10
        stream = synthetic_stream(cfg, batch=2, frames=16,
                                  n=steps * cfg.train.grad_accum_steps)
        val = [synthetic_batch(cfg, batch=2, frames=16, seed=10_000)]
    else:
        stream, val = data_streams(cfg, args.data_root, device)
    out = Path(args.output_dir)
    trainer = UnifiedTrainer(
        cfg, stream, val, blocks=blocks, device=device,
        callbacks=[JSONLLogger(str(out / "train_log.jsonl"), every=1),
                   StepTimeArtifact(str(out / "step_times.json"))])
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
    p.add_argument("--checkpoint")
    p.add_argument("--zoo", nargs="?", const="", metavar="DIR",
                   help="load the git-tracked pretrained zoo exports "
                        "(default dir: eval_results/zoo) with its config")
    p.add_argument("--sde", action="store_true")
    p.add_argument("--out", default="synth.wav")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.checkpoint:
        raise NotImplementedError("checkpoints are not ported yet")

    import torch
    from ttsx_torch.core.config import TTSXConfig
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
        pipe = fresh_init_(TTSPipeline(TTSXConfig()),
                           torch.Generator().manual_seed(args.seed)).to(device)
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
                      "seconds": wav.shape[1] / cfg.vocoder.sr}))
    return 0


if __name__ == "__main__":
    sys.exit(main_train())
