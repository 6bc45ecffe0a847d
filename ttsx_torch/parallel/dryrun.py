"""The three-stage training step over n ranks (``__graft_entry__.py``'s
``dryrun_multichip``).

    python -m ttsx_torch.parallel.dryrun N [--device cuda|cpu] [--tp TP]

``dryrun_multichip(n)`` starts n processes, one rank each, in one
process group on ``localhost`` (NCCL on n cards, one each; gloo on the
CPU when ``device="cpu"``) and returns rank 0's result. Each rank steps
the acoustic, refiner and vocoder blocks once on the reference's tiny
dryrun config (``tiny_cfg``) over a (dp, tp) mesh: by the reference's
rule tp = 2 where n is even and at least 4, else tp = 1, or the ``tp``
asked for; with tp > 1 the generator's ``band_tp`` is on (4 bands over
tp ranks). The global batch has n rows; this rank keeps its dp rows.
``dryrun_step`` is that body inside a group the caller made. Rank 0
then runs the same step alone, without a mesh, on the global batch, and
the result is ``ok`` when every loss is finite and every entry of the
three blocks' states (parameters, buffers, Adam moments, the generator's
EMA) agrees with the single-rank run within ``RTOL`` / ``ATOL``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ttsx_torch.core.config import (AcousticConfig, MeshConfig,
                                    RefinerConfig, S4Config, TrainConfig,
                                    TTSXConfig, VocoderConfig)
from ttsx_torch.core.mesh import BACKEND, Mesh, make_mesh, shard_batch
from ttsx_torch.parallel.spawn import run_ranks

RTOL, ATOL = 1e-4, 1e-6     # mesh run vs one rank, every state entry


def tiny_cfg() -> TTSXConfig:
    """``__graft_entry__._tiny_cfg``: the dryrun's tiny three-block config
    (4 vocoder bands, hop 16)."""
    s4 = S4Config(heads=2, norm_groups=2, causal=True, dropout=0.0)
    return TTSXConfig(
        acoustic=AcousticConfig(text_emb_dim=16, hidden_channels=16,
                                conformer_layers=1, transformer_dim=32,
                                num_layers=1, attention_heads=2,
                                speaker_dim=8),
        refiner=RefinerConfig(levels=1, cond_dim=16, hidden_channels=16,
                              hsf_hidden=8, style_dim=8, beta_hidden=8,
                              s4=s4, sde_steps=2, vq_dims=(80,),
                              vq_codes=(16,)),
        vocoder=VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                              disc_ch_growth=2, disc_periods=(2, 3),
                              disc_kernel_sizes=(5, 7, 7),
                              res_dilations=(1, 3), upsample_factors=(4, 4),
                              stft_sizes=(64,)),
        train=TrainConfig(warmup_steps=2, max_steps=10))


def dryrun_batch(cfg: TTSXConfig, rows: int, frames: int = 8,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """The dryrun's global batch (the reference's keys and shapes, drawn
    from numpy)."""
    rng = np.random.default_rng(seed)
    hop = math.prod(cfg.vocoder.upsample_factors)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)
    emo = np.exp(normal(rows, 6))
    return {"text_emb": normal(rows, frames, cfg.acoustic.text_emb_dim),
            "prosody": normal(rows, frames, 18),
            "emotion_probs": emo / emo.sum(1, keepdims=True),
            "mel": normal(rows, frames, 80),
            "speaker": normal(rows, cfg.acoustic.speaker_dim),
            "style_id": np.zeros(rows, np.int64),
            "wav": normal(rows, frames * hop, 1) * 0.1}


def _step(cfg: TTSXConfig, device, batch: Dict, mesh: Optional[Mesh]):
    """One step of the three blocks; (losses, flat states)."""
    from ttsx_torch.train.blocks import (AcousticBlock, RefinerBlock,
                                         VocoderBlock, as_tensors)
    from ttsx_torch.train.checkpoint import flatten
    blocks = {"acoustic": AcousticBlock(cfg, device, 0),
              "refiner": RefinerBlock(cfg, device, 1),
              "vocoder": VocoderBlock(cfg, device, 2)}
    b = as_tensors(batch, device)
    with mesh if mesh is not None else contextlib.nullcontext():
        if mesh is not None:
            b = shard_batch(b, mesh)
        a = blocks["acoustic"].train_step(b)
        r = blocks["refiner"].train_step(b, a["mel_pred"], 1.0, 1.0)
        d = blocks["vocoder"].disc_step(b)
        g = blocks["vocoder"].gen_step(b)
    losses = {"acoustic_loss": float(a["metrics"]["loss"]),
              "refiner_loss": float(r["metrics"]["loss"]),
              "d_loss": float(d["d_loss"]), "g_loss": float(g["g_loss"])}
    if mesh is not None:
        losses = mesh.mean(losses)
    states = flatten({k: v.state_dict() for k, v in blocks.items()})
    return losses, {k: v.detach().cpu().clone() for k, v in states.items()
                    if v.is_floating_point()}


def generator_numel() -> int:
    """The zoo generator's parameter count (built on the meta device)."""
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.models.vocoder import Generator
    cfg = zoo_cfg()
    with torch.device("meta"):
        gen = Generator(cfg.vocoder, cfg.acoustic.cond_dim,
                        cfg.acoustic.emotion_dim)
    return sum(p.numel() for p in gen.parameters())


def dryrun_step(mesh: Mesh, rows: Optional[int] = None, seed: int = 0
                ) -> Dict:
    """The dryrun on ``mesh`` (inside the caller's process group): the
    step over the mesh, then, on rank 0, the same step alone. Every rank
    returns the mesh run's losses; rank 0's result also holds the
    comparison and ``ok``. On CUDA it also times an all-reduce over every
    rank of the zoo generator's gradient size (``allreduce``)."""
    cfg = tiny_cfg()
    if mesh.tp > 1:
        cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(
            cfg.vocoder, band_tp=True))
    batch = dryrun_batch(cfg, rows or mesh.size, seed=seed)
    losses, states = _step(cfg, mesh.device, batch, mesh)
    out = {"world": mesh.size, "dp": mesh.dp, "tp": mesh.tp,
           "band_tp": cfg.vocoder.band_tp, "rows": len(batch["mel"]),
           "losses": losses,
           "finite": all(math.isfinite(v) for v in losses.values())}
    if mesh.device.type == "cuda":
        numel = generator_numel()
        out["allreduce"] = {"numel": numel, "bytes": 4 * numel,
                            "ms": mesh.time_all_reduce(numel)}
    if mesh.rank == 0:
        one, ref = _step(cfg, mesh.device, batch, None)
        worst, bad = 0.0, []
        for k, w in ref.items():
            diff = (states[k] - w).abs()
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
            if not bool((diff <= ATOL + RTOL * w.abs()).all()):
                bad.append(k)
        loss_rel = max(abs(losses[k] - one[k]) / max(abs(one[k]), 1e-12)
                       for k in one)
        out.update(one_rank_losses=one, state_max_abs_diff=worst,
                   state_entries=len(ref), state_entries_off=bad[:8],
                   loss_max_rel_diff=loss_rel, rtol=RTOL, atol=ATOL,
                   ok=out["finite"] and not bad and loss_rel <= RTOL)
    mesh.barrier()
    return out


def dryrun_multichip(n: int, device="cuda", tp: Optional[int] = None,
                     timeout: float = 900.0) -> Dict:
    """The dryrun over ``n`` ranks in ``n`` processes (n cards for
    ``cuda``), tp by the reference's rule or as given; rank 0's result.
    Raises if a rank fails or the result is not ``ok``."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun over {n} ranks needs {n} cards, "
                           f"{torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.json"
        run_ranks("ttsx_torch.parallel.dryrun",
                  n, [str(n), "--device", device, "--out", str(out)]
                  + (["--tp", str(tp)] if tp else []), timeout)
        result = json.loads(out.read_text())
    if not result["ok"]:
        raise RuntimeError(f"dryrun over {n} ranks: {result}")
    return result


def _rank_main(n: int, rank: int, port: int, device: str,
               out: Optional[str], tp: Optional[int] = None) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        from ttsx_torch.core.device import set_f32_numerics
        set_f32_numerics()
    else:
        torch.set_num_threads(1)
    dist.init_process_group(BACKEND[dev.type],
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        if tp is None:
            tp = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = make_mesh(MeshConfig(dp=n // tp, tp=tp), device=dev.type)
        result = dryrun_step(mesh)
        if rank == 0 and out:
            Path(out).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--tp", type=int, default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        print(json.dumps(dryrun_multichip(args.n, args.device, args.tp)))
        return 0
    _rank_main(args.n, args.rank, args.port, args.device, args.out,
               args.tp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
