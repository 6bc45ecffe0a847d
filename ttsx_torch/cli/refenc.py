"""The speaker encoder's console scripts (``ttsx/cli/refenc.py``):
``refenc-train``, ``refenc-eer``, ``refenc-latency`` and ``refenc-fuse``,
on ``--device`` (default ``cuda``; the CPU only when asked), ``--seed``
and ``--output-dir``.

    python -m ttsx_torch.cli.refenc train LIST [--eval-list LIST]
        [--max-steps N] [--batch 8] [--crop-seconds 3.0] [--workers 2]
        [--eval-every N] [--no-augment]
    python -m ttsx_torch.cli.refenc eer LIST (--checkpoint DIR | --allow-random)
    python -m ttsx_torch.cli.refenc latency [--runs 100]
    python -m ttsx_torch.cli.refenc fuse [--checkpoint DIR] [--out FILE]

A list holds one ``path<TAB>speaker`` per line. ``main_refenc_train``
trains the encoder at its full default width (``RefEncConfig``: ECAPA-TDNN
512 channels, a 256-d embedding, ArcFace over the list's speakers) on
random crops of ``--crop-seconds`` from the prefetching wav loader, each
speaker's files repeated up to the largest speaker's count so that the
loader's uniform draws are balanced; each batch's log-mel is one call on
the device, then SpecAugment (15 bins, 35 frames) on the host unless
``--no-augment``; a batch holding an undecodable file is dropped. With
``--eval-list`` the EER of its files (cropped or zero-padded to the
crop) is taken every ``--eval-every`` steps; ``best`` (lowest EER) and
``final`` go to ``--output-dir``/checkpoints, and one JSON line is
printed. The other three read such a checkpoint directory: its encoder
weights alone, from ``best`` or else ``final``, so a checkpoint written
on the card loads on the CPU and back. ``refenc-eer`` embeds each file
whole at batch 1 and prints the all-pairs EER; ``refenc-latency`` times
the forward on a 2 s mel (172 frames); ``refenc-fuse`` writes the
encoder as a ``torch.export`` program (``.pt2``, in place of the
reference's StableHLO) and checks that the file reloads and runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ttsx_torch.cli.main import add_common_args, device_from_args

ENCODER_PREFIX = "refenc/params/model."   # the encoder's keys in a checkpoint


def restore_encoder(model, checkpoint: str) -> str:
    """Load the encoder weights of a ``refenc-train`` checkpoint
    directory into ``model`` (``best``, else ``final``); returns the tag.
    Exits when the directory holds neither."""
    from ttsx_torch.train.checkpoint import check_like, read_checkpoint
    for tag in ("best", "final"):
        got = read_checkpoint(checkpoint, tag)
        if got is not None:
            n = len(ENCODER_PREFIX)
            state = {k[n:]: v for k, v in got[0].items()
                     if k.startswith(ENCODER_PREFIX)}
            check_like(state, model.state_dict(),
                       f"{Path(checkpoint) / tag}: the encoder")
            model.load_state_dict(state)
            return tag
    raise SystemExit(f"no best/ or final/ checkpoint under {checkpoint}")


def load_encoder(cfg, device, seed: int, checkpoint=None):
    """A ``ReferenceEncoder(cfg)`` on ``device`` in eval mode: the
    trainer's fresh init from ``seed``, then ``checkpoint``'s weights when
    one is given."""
    import torch
    from ttsx_torch.models.reference_encoder import ReferenceEncoder
    from ttsx_torch.nn.init import fresh_init_
    model = fresh_init_(ReferenceEncoder(cfg),
                        torch.Generator().manual_seed(seed))
    if checkpoint:
        restore_encoder(model, checkpoint)
    return model.to(device).eval()


def embed_files(model, items, device):
    """Unit embeddings [N, speaker_dim] (numpy) of the files of ``items``
    ((path, speaker) pairs), each whole at batch 1, and their speakers."""
    import numpy as np
    import torch
    from ttsx_torch.data.dataset import read_wav
    from ttsx_torch.dsp.stft import mel_spectrogram
    audio = model.cfg.audio
    embs, spks = [], []
    with torch.inference_mode():
        for path, spk in items:
            wav, _ = read_wav(path, audio.sample_rate)
            mel = mel_spectrogram(torch.as_tensor(wav[None], device=device),
                                  audio)
            embs.append(model(mel)[0].cpu().numpy())
            spks.append(spk)
    return np.stack(embs), spks


def main_refenc_train(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-refenc-train")
    add_common_args(p)
    p.add_argument("file_list")
    p.add_argument("--eval-list", help="held-out list for periodic EER")
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--crop-seconds", type=float, default=3.0)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--no-augment", action="store_true")
    args = p.parse_args(argv)
    device = device_from_args(args)

    import numpy as np
    import torch
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.data import (WavBatchLoader, load_file_list, read_wav,
                                 spec_augment)
    from ttsx_torch.dsp.stft import mel_spectrogram
    from ttsx_torch.train.refenc_trainer import RefEncTrainer

    items = load_file_list(args.file_list)
    spk2id = {s: i for i, s in enumerate(sorted({s for _, s in items}))}
    cfg = RefEncConfig(num_speakers=max(len(spk2id), 2),
                       total_steps=args.max_steps,
                       eval_every=args.eval_every)
    sr = cfg.audio.sample_rate
    crop = int(args.crop_seconds * sr)
    trainer = RefEncTrainer(cfg, device, seed=args.seed)
    rng = np.random.default_rng(args.seed)

    def mel_of(wav_batch):
        with torch.no_grad():
            return mel_spectrogram(torch.as_tensor(wav_batch, device=device),
                                   cfg.audio)

    def to_mel(wav_batch):
        mel = mel_of(wav_batch)
        if args.no_augment:
            return mel
        return spec_augment(mel.cpu().numpy(), rng, freq_mask=15,
                            time_mask=35)

    eval_fn = None
    if args.eval_list:
        ev_batches = []
        mels, labs = [], []
        for path, spk in load_file_list(args.eval_list):
            wav, _ = read_wav(path, sr)
            wav = (np.pad(wav, (0, max(0, crop - len(wav))))[:crop]
                   .astype(np.float32))
            mels.append(mel_of(wav[None]))
            labs.append(spk2id.get(spk, -1))
            if len(mels) == args.batch:
                ev_batches.append((torch.cat(mels), np.asarray(labs)))
                mels, labs = [], []
        if mels:
            ev_batches.append((torch.cat(mels), np.asarray(labs)))
        eval_fn = lambda tr: tr.evaluate_eer(ev_batches)  # noqa: E731

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    by_spk: dict = {}
    for pa, s in items:
        by_spk.setdefault(s, []).append(pa)
    cap = max(len(v) for v in by_spk.values())
    balanced = [(v[i % len(v)], spk2id[s])
                for s, v in by_spk.items() for i in range(cap)]
    with WavBatchLoader(balanced, crop=crop, batch=args.batch,
                        sample_rate=sr, workers=args.workers,
                        seed=args.seed) as loader:
        stream = ((to_mel(w), l) for w, l in loader if (l >= 0).all())
        res = trainer.train(stream, eval_fn=eval_fn,
                            max_steps=args.max_steps,
                            checkpoint_dir=str(out / "checkpoints"))
        native = loader.is_native
    print(json.dumps({"steps": res["steps"], "best_eer": res["best_eer"],
                      "n_speakers": len(spk2id),
                      "native_loader": native,
                      "checkpoints": str(out / "checkpoints")}))
    return 0


def main_refenc_eer(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-refenc-eer")
    add_common_args(p)
    p.add_argument("file_list")
    p.add_argument("--checkpoint",
                   help="checkpoint dir written by refenc-train "
                        "(containing best/ or final/)")
    p.add_argument("--allow-random", action="store_true",
                   help="permit an EER run on freshly initialized weights "
                        "(meaningless number; for harness smoke tests only)")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.allow_random:
        # an EER from random weights looks like a metric but is not one
        p.error("refenc-eer requires --checkpoint (or --allow-random to "
                "explicitly accept a meaningless random-weight EER)")
    device = device_from_args(args)

    import numpy as np
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.data.dataset import load_file_list
    from ttsx_torch.eval.metrics import all_pairs_eer
    model = load_encoder(RefEncConfig(), device, args.seed, args.checkpoint)
    embs, spks = embed_files(model, load_file_list(args.file_list), device)
    uniq = {s: i for i, s in enumerate(sorted(set(spks)))}
    eer = all_pairs_eer(embs, np.asarray([uniq[s] for s in spks]))
    print(json.dumps({"eer": eer, "n": len(embs)}))
    return 0


def main_refenc_latency(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-refenc-latency")
    add_common_args(p)
    p.add_argument("--runs", type=int, default=100)
    args = p.parse_args(argv)
    device = device_from_args(args)

    import torch
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.eval.benchmarks import time_fn
    from ttsx_torch.eval.export import example_mel
    cfg = RefEncConfig()
    model = load_encoder(cfg, device, args.seed)
    with torch.inference_mode():
        stats = time_fn(model, example_mel(cfg, device), runs=args.runs)
    print(json.dumps({"avg_ms": stats["mean_s"] * 1e3, "runs": args.runs}))
    return 0


def main_refenc_fuse(argv=None) -> int:
    p = argparse.ArgumentParser("ttsx-torch-refenc-fuse")
    add_common_args(p)
    p.add_argument("--checkpoint", help="refenc-train checkpoint dir")
    p.add_argument("--out", default="reference_encoder_exported.pt2")
    args = p.parse_args(argv)
    device = device_from_args(args)

    import torch
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.eval.export import (example_mel,
                                        export_reference_encoder, load_pt2)
    cfg = RefEncConfig()
    model = load_encoder(cfg, device, args.seed, args.checkpoint)
    blob = export_reference_encoder(model, args.out)
    with torch.no_grad():
        load_pt2(args.out)(example_mel(cfg, device))
    print(json.dumps({"path": args.out, "bytes": len(blob),
                      "aot_compiled": True}))
    return 0


SCRIPTS = {"train": main_refenc_train, "eer": main_refenc_eer,
           "latency": main_refenc_latency, "fuse": main_refenc_fuse}


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in SCRIPTS:
        sys.exit(f"usage: python -m ttsx_torch.cli.refenc "
                 f"{{{','.join(SCRIPTS)}}} ...")
    sys.exit(SCRIPTS[sys.argv[1]](sys.argv[2:]))
