"""Closed-loop bucketed serving: ``SynthesisServer.serve_batch``.

One client sends a full bucket of ``batch`` requests, waits for the
waveforms on the host and sends the next, for the run's seconds. Set-up
builds the pipeline of the cell's configuration on the card, loads the
benchmark's weights (``perfbench.weights``, from the seed), builds the
server (``bf16`` as the configuration states) and serves
``warmup_calls`` buckets of the pool, which builds and loads every kernel
and warms every shape the window uses (each bucket is padded to
``frames``).

End to end: ``serve_audio_rate``, the seconds of audio requested (the
unpadded lengths) and returned over the window's wall time;
``serve_p95_ms``, the 95th percentile of every request's latency, from
its call's start to its waveform on the host; ``setup_s``.

Correctness: forward hooks on the pipeline's acoustic model and refiner
keep each call's mel0 and refined mel. The calls checked are two drawn
from the seed over the window (a reservoir) and the first window call
that holds the pool's longest request. After the window, with the
server freed, the reference (``perfbench/reference``, float32, TF32 off)
synthesizes the same padded buckets from the same weights, and each
request's served frames are compared: the largest absolute gap of mel0,
of the refined mel (through K4) and of the waveform (through K1 and K2).

Traced run: the same window, with ``torch.profiler`` over ``trace_calls``
whole calls from the ``trace_from``-th on, the stages opened as host
ranges by the benchmark's own forward hooks, and the S4 layers' input
shapes recorded for K4's count.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np

from perfbench import traffic
from perfbench.trace import Stretch
from perfbench.weights import draw_weights, load_weights

STAGES = ("acoustic", "refiner", "gst", "generator")


def port_config(cell):
    from ttsx_torch.core.config import TTSXConfig, from_dict
    return from_dict(TTSXConfig, cell.config["config"])


def dims(cfg) -> Dict[str, int]:
    ac = cfg.acoustic
    return dict(text=ac.text_emb_dim, cond=ac.cond_dim,
                emotion=ac.emotion_dim, speaker=ac.speaker_dim,
                styles=cfg.refiner.num_styles)


def pad(reqs: List[Dict], batch: int, frames: int, d: Dict[str, int]):
    """The padded bucket, as numpy: text, prosody, emotion, speaker, style
    id and lengths (unused rows: zeros, uniform emotion)."""
    text = np.zeros((batch, frames, d["text"]), np.float32)
    pros = np.zeros((batch, frames, d["cond"]), np.float32)
    emo = np.full((batch, d["emotion"]), 1 / d["emotion"], np.float32)
    spk = np.zeros((batch, d["speaker"]), np.float32)
    sid = np.zeros((batch,), np.int64)
    lens = np.zeros(batch, np.int64)
    for i, r in enumerate(reqs):
        n = min(len(r["text_emb"]), frames)
        text[i, :n] = r["text_emb"][:n]
        pros[i, :n] = r["prosody"][:n]
        emo[i] = r["emotion_probs"]
        spk[i] = r["speaker"]
        sid[i] = r["style_id"]
        lens[i] = n
    return text, pros, emo, spk, sid, lens


def reference_outputs(cell, seed: int, buckets: List[tuple], device: str,
                      tf32: bool = False, count_flops: bool = False):
    """The reference's (mel0, mel_ref, wav) as numpy for each padded
    bucket, from the benchmark's weights for ``seed``; with ``tf32`` the
    products run in TF32 (the control). With ``count_flops`` also the
    matmul, convolution and attention FLOPs of one bucket."""
    import torch
    from perfbench.compare import FlopCount
    from perfbench.reference.core.config import TTSXConfig, from_dict
    from perfbench.reference.models.pipeline import TTSPipeline
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = TTSPipeline(from_dict(TTSXConfig, cell.config["config"])).to(
            device)
        load_weights(ref, draw_weights(ref, seed, device))
        outs, flops = [], None
        for i, arrays in enumerate(buckets):
            t = [torch.as_tensor(a, device=device) for a in arrays[:5]]
            if count_flops and i == 0:
                with FlopCount() as fc:
                    o = ref.synthesize(*t)
                flops = fc.total
            else:
                o = ref.synthesize(*t)
            outs.append(tuple(x.float().cpu().numpy()
                              for x in (o.mel0, o.mel_ref, o.wav)))
        del ref
        return outs, flops
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def gaps(kept: List[dict], ref: List[tuple], hop: int) -> Dict[str, float]:
    """The largest absolute gap over every kept request's served frames."""
    g = {"mel0_gap": 0.0, "mel_ref_gap": 0.0, "wav_gap": 0.0}
    for k, (r0, rr, rw) in zip(kept, ref):
        for j, n in enumerate(k["lens"]):
            n = int(n)
            if n == 0:
                continue
            g["mel0_gap"] = max(g["mel0_gap"], float(
                np.abs(k["mel0"][j, :n] - r0[j, :n]).max()))
            g["mel_ref_gap"] = max(g["mel_ref_gap"], float(
                np.abs(k["mel_ref"][j, :n] - rr[j, :n]).max()))
            g["wav_gap"] = max(g["wav_gap"], float(
                np.abs(k["wavs"][j] - rw[j, :n * hop, 0]).max()))
    return g


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    import torch
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    cfg = port_config(cell)
    B, T = tr["batch"], tr["frames"]
    hop, sr = cfg.vocoder.hop_length, cfg.audio.sample_rate
    d = dims(cfg)
    pipe = TTSPipeline(cfg).to(dev)
    load_weights(pipe, draw_weights(pipe, ctx.seed, dev))
    srv = SynthesisServer(pipe, device=dev, max_batch=B, frames=T,
                          bf16=cell.config["serve_bf16"])
    pool = traffic.serve_pool(tr, d, ctx.seed)
    reqs = [SynthesisRequest(**r) for r in pool]

    def call(i):
        return [reqs[k] for k in traffic.call_indices(i, B, len(pool))]

    seen = {}

    def keep(name):
        def hook(_m, _inp, out):
            seen[name] = out.mel if name == "mel0" else out.mel_ref
        return hook

    handles = [srv.pipe.acoustic.register_forward_hook(keep("mel0")),
               srv.pipe.refiner.register_forward_hook(keep("mel_ref"))]
    for i in range(tr["warmup_calls"]):
        srv.serve_batch(call(i))
    _sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()

    longest = max(range(len(pool)), key=lambda k: len(pool[k]["text_emb"]))
    rng = random.Random(ctx.seed)
    kept: Dict[str, dict] = {}
    lat: List[float] = []
    times: List[tuple] = []
    audio_s, attempted, failed = 0.0, 0, 0
    stretch, rec_shapes = None, []
    setup_s = time.perf_counter() - ctx.t0
    t_start = time.perf_counter()
    i = 0
    while True:
        traced = ctx.trace and tr["trace_from"] <= i < tr["trace_from"] \
            + tr["trace_calls"]
        if ctx.trace and i == tr["trace_from"]:
            stretch, hooks = _open_stretch(srv.pipe, dev, rec_shapes)
        batch = call(i)
        c0 = time.perf_counter()
        try:
            outs = srv.serve_batch(batch)
            ok = len(outs) == len(batch) and all(
                len(o) == len(r.text_emb) * hop and np.isfinite(o).all()
                for o, r in zip(outs, batch))
        except (RuntimeError, ValueError) as e:
            ctx.note(call=i, error=repr(e))
            outs, ok = None, False
        c1 = time.perf_counter()
        attempted += len(batch)
        if ok:
            lat.extend([c1 - c0] * len(batch))
            audio_s += sum(len(r.text_emb) for r in batch) * hop / sr
            # the call with the pool's longest request, and a reservoir
            # of two calls drawn uniformly over the window
            drawn = [k for k in kept if k != "longest"]
            slot = None
            if longest in traffic.call_indices(i, B, len(pool)) \
                    and "longest" not in kept:
                slot = "longest"
            elif len(drawn) < 2:
                slot = f"r{len(drawn)}"
            elif rng.random() < 2.0 / (i + 1):
                slot = f"r{rng.randrange(2)}"
            if slot is not None:
                kept[slot] = dict(call=i, wavs=outs,
                                  lens=[len(r.text_emb) for r in batch],
                                  mel0=seen["mel0"].float().cpu().numpy(),
                                  mel_ref=seen["mel_ref"].float().cpu().numpy())
        else:
            failed += len(batch)
        times.append((c0, c1, traced))
        i += 1
        if stretch is not None and i == tr["trace_from"] + tr["trace_calls"]:
            _close_stretch(stretch, hooks)
        if c1 - t_start >= ctx.seconds and (
                not ctx.trace or i >= tr["trace_from"] + tr["trace_calls"]):
            break
    window_s = time.perf_counter() - t_start
    peak = int(torch.cuda.max_memory_allocated()) if dev == "cuda" else 0
    if stretch is not None:
        stretch.reduce()
    for h in handles:
        h.remove()
    del srv, pipe, seen
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    checked = [kept[k] for k in sorted(kept)]
    buckets = [pad([pool[k] for k in traffic.call_indices(c["call"], B,
                                                          len(pool))],
                   B, T, d) for c in checked]
    ref, flops = reference_outputs(cell, ctx.seed, buckets, dev,
                                   count_flops=ctx.trace)
    g = gaps(checked, ref, hop)
    control = None
    if ctx.control:
        low, _ = reference_outputs(cell, ctx.seed, buckets, dev, tf32=True)
        control = gaps([dict(lens=c["lens"], mel0=m0, mel_ref=mr,
                             wavs=[w[j, :int(n) * hop, 0]
                                   for j, n in enumerate(c["lens"])])
                        for c, (m0, mr, w) in zip(checked, low)], ref, hop)
    lim = cell.limits
    checks = {k: (v, lim[k]) for k, v in g.items()}
    checks["failed_requests"] = (failed, 0)
    checks["checked_requests"] = (sum(int(n > 0) for c in checked
                                      for n in c["lens"]), 1)
    correct = (all(v <= lim[k] for k, v in g.items()) and failed == 0
               and checks["checked_requests"][0] >= 1)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               memory_peak_bytes=peak, checks=checks,
               e2e={"serve_audio_rate": audio_s / window_s,
                    "serve_p95_ms": 1e3 * _p95(lat),
                    "setup_s": setup_s})
    if control is not None:
        out["control"] = control
    ctx.note(requests=attempted, failed=failed, calls=i, window_s=window_s,
             p95_from=len(lat))
    if ctx.trace and stretch is not None:
        plain = [(c0, c1) for c0, c1, t in times if not t]
        out.update(busy_s=stretch.trace["busy_s"], window_s=stretch.window_s,
                   breakdown={"device_ops": stretch.trace["device_ops"],
                              "idle_gaps": stretch.trace["idle_gaps"]},
                   record=dict(trace=stretch.trace,
                               stretch_s=stretch.window_s,
                               calls=tr["trace_calls"], batch=B, frames=T,
                               vocoder=cell.config["config"]["vocoder"],
                               s4_shapes=rec_shapes,
                               flops_per_call=flops,
                               untraced_calls=len(plain),
                               untraced_s=sum(c1 - c0 for c0, c1 in plain),
                               kind="serve", device=dev))
    return out


def _p95(values: List[float]) -> float:
    from perfbench.harness import quantile
    return quantile(values, 0.95)


def _open_stretch(pipe, dev, shapes):
    import torch
    hooks, opened = [], {}
    for name in STAGES:
        mod = getattr(pipe, name)

        def pre(_m, _inp, name=name):
            opened[name] = torch.profiler.record_function(f"stage.{name}")
            opened[name].__enter__()

        def post(_m, _inp, _out, name=name):
            opened.pop(name).__exit__(None, None, None)
        hooks.append(mod.register_forward_pre_hook(pre))
        hooks.append(mod.register_forward_hook(post))
    for m in pipe.refiner.modules():
        if type(m).__name__ == "S4":
            def s4(mod, inp):
                B, T, C = inp[0].shape
                H, dd = mod.a_diag.shape
                shapes.append((B, T, C, H, dd))
            hooks.append(m.register_forward_pre_hook(s4))
    stretch = Stretch(dev)
    stretch.__enter__()
    return stretch, hooks


def _close_stretch(stretch, hooks):
    stretch.__exit__(None, None, None)
    for h in hooks:
        h.remove()
