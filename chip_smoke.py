#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``ttsx_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, one JSON line each:

1. env: torch/CUDA versions, the card, ``nvidia-smi`` name and power limit.
2. build: nvcc of every ``ttsx_torch/ops/csrc/*.cu`` (in parallel) and the
   ptxas register / shared-memory / spill lines of each kernel.
3. kernels: K1 (ConvT upsample) and K2 (FiLM resblock stack) against
   their plain PyTorch versions on the card, at the four generator stage
   shapes of one 10 s request (864 mel frames, 4 bands folded into the
   batch: B*4 = 4) and of the serving bucket (4 requests: B*4 = 16),
   within stated tolerances.
4. serve: ``serve_from_zoo(device="cuda", bf16=False, max_batch=4,
   frames=864)`` on the checked-in zoo model serves 3 requests (864, 600,
   300 frames, made from ``--seed``): finite, non-silent waveforms of
   ``len * 256`` samples; the launch counters, zeroed just before, show
   K1 and K2 ran 4 times each; the same requests through the generator
   with both kernel flags off (plain PyTorch on the card) give the same
   waveforms within a stated tolerance.
5. timing: CUDA-event times at the same shapes of each kernel beside
   its plain version, K1's library call (``F.conv_transpose1d``, timed
   here only), each kernel's bound from bytes and f32 operations, the
   model stages, and one 10 s request end to end.

Then the ``{"kernels": [...]}`` line (at the serving bucket's shapes:
``ms`` and the bounds summed over the four stage calls of one forward),
the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero without the ``ok`` line. Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, and HBM3 bandwidth. The port's kernels run f32 FMAs.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TIME_LIMIT_S = 1150

FRAMES = 864            # one 10 s request at 22050 Hz, hop 256
MAX_BATCH = 4           # the serving bucket: 4 requests x 864 frames
REQUEST_FRAMES = (864, 600, 300)
K1_TOL = (1e-4, 1e-4)   # |kernel - plain| <= atol + rtol * |plain|
K2_TOL = (2e-4, 2e-4)
WAV_TOL = 5e-4          # max |wav(kernels) - wav(plain)|, tanh output
SILENT = 1e-3           # a waveform whose peak is below this is silent


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, target_ms: float = 150.0) -> float:
    """Mean ms of ``fn`` on the card: CUDA events around a run of calls
    after a warm-up, sized to take about ``target_ms``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t) * 1e3
    iters = max(3, min(50, int(target_ms / max(once, 1e-3))))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb > tf else "operations")


def err(got, ref):
    d = (got - ref).abs()
    return float(d.max()), float(d.max() / ref.abs().max().clamp_min(1e-30))


def within(got, ref, tol) -> bool:
    atol, rtol = tol
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


# ------------------------------------------------------------ kernel shapes
def stage_shapes(vc, frames: int, batch: int):
    """(K1 args, K2 args) of each generator stage for ``batch`` requests of
    ``frames`` mel frames: K1 x [4B, T, Cin] -> [4B, T*f, Cout]; K2 x
    [4B, T*f, Cout] with the film at the mel rate, batch B."""
    out, ch, t = [], vc.hidden_dim, frames
    for f in vc.upsample_factors:
        out.append(dict(B=vc.num_bands * batch, T=t, cin=ch, cout=ch // 2, f=f,
                        Bf=batch, Tf=frames))
        ch //= 2
        t *= f
    return out


def make_k1(s, gen):
    import torch
    x = torch.randn(s["B"], s["T"], s["cin"], generator=gen)
    w = torch.randn(2 * s["f"], s["cin"], s["cout"], generator=gen) \
        * (2 * s["cin"]) ** -0.5
    b = torch.randn(s["cout"], generator=gen) * 0.1
    return [a.cuda() for a in (x, w, b)]


def make_k2(s, gen, n: int):
    import torch
    C = s["cout"]
    x = torch.randn(s["B"], s["T"] * s["f"], C, generator=gen)
    film = torch.randn(s["Bf"], s["Tf"], 2 * n * C, generator=gen) * 0.3
    w1 = torch.randn(n, 3, C, 2 * C, generator=gen) * (3 * C) ** -0.5
    b1 = torch.randn(n, 2 * C, generator=gen) * 0.1
    w2 = torch.randn(n, 3, C, C, generator=gen) * (3 * C) ** -0.5
    b2 = torch.randn(n, C, generator=gen) * 0.1
    return [a.cuda() for a in (x, film, w1, b1, w2, b2)]


def k1_cost(s):
    rows = s["B"] * s["T"] * s["f"]
    nbytes = 4 * (s["B"] * s["T"] * s["cin"] + 2 * s["f"] * s["cin"] * s["cout"]
                  + s["cout"] + rows * s["cout"])
    return nbytes, rows * s["cout"] * 4 * s["cin"]


def k2_cost(s, n: int):
    C, rows = s["cout"], s["B"] * s["T"] * s["f"]
    nbytes = 4 * (2 * rows * C + s["Bf"] * s["Tf"] * 2 * n * C
                  + n * (9 * C * C + 3 * C))
    return nbytes, rows * n * 18 * C * C


def requests(cfg, seed: int):
    import numpy as np
    from ttsx_torch.serve import SynthesisRequest
    rng = np.random.default_rng(seed)
    ac = cfg.acoustic
    return [SynthesisRequest(
        text_emb=rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        prosody=rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        emotion_probs=rng.dirichlet(np.ones(ac.emotion_dim)).astype(np.float32),
        speaker=(0.5 * rng.standard_normal(ac.speaker_dim)).astype(np.float32),
        style_id=int(rng.integers(0, cfg.refiner.num_styles)))
        for n in REQUEST_FRAMES]


def check_kernels(shapes, gen, dil):
    """Each kernel against its plain version at each stage shape."""
    import torch
    from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                               film_resblock_stack_plain)
    from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain
    checks = {"upsample": [], "resblock_stack": []}
    for s in shapes:
        x, w, b = make_k1(s, gen)
        got, ref = (convt_upsample(x, w, b, s["f"]),
                    convt_upsample_plain(x, w, b, s["f"]))
        torch.cuda.synchronize()
        checks["upsample"].append(dict(
            shape=[s["B"], s["T"], s["cin"], s["cout"], s["f"]],
            ok=within(got, ref, K1_TOL))
            | dict(zip(("max_abs_err", "max_rel_err"), err(got, ref))))
        a = make_k2(s, gen, len(dil))
        got, ref = (film_resblock_stack(*a, dil),
                    film_resblock_stack_plain(*a, dil))
        torch.cuda.synchronize()
        checks["resblock_stack"].append(dict(
            shape=[s["B"], s["T"] * s["f"], s["cout"], s["Bf"], s["Tf"]],
            ok=within(got, ref, K2_TOL))
            | dict(zip(("max_abs_err", "max_rel_err"), err(got, ref))))
        del x, w, b, a, got, ref
    return checks


def time_kernels(shapes, gen, dil):
    """Per stage: kernel, plain and (K1) library ms, and the bound."""
    import torch.nn.functional as F
    from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                               film_resblock_stack_plain)
    from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain
    rows = {"upsample": [], "resblock_stack": []}
    for s in shapes:
        x, w, b = make_k1(s, gen)
        wt = w.permute(1, 2, 0).flip(-1).contiguous()     # torch [Cin, Cout, k]
        xc = x.transpose(1, 2).contiguous()
        lo, tf = s["f"] // 2, s["T"] * s["f"]
        nbytes, flops = k1_cost(s)
        bms, by = bound_ms(nbytes, flops)
        rows["upsample"].append(dict(
            ms=cuda_ms(lambda: convt_upsample(x, w, b, s["f"])),
            plain_ms=cuda_ms(lambda: convt_upsample_plain(x, w, b, s["f"])),
            library_ms=cuda_ms(lambda: F.conv_transpose1d(
                xc, wt, b, stride=s["f"])[:, :, lo:lo + tf]),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9, mbytes=nbytes / 1e6))
        a = make_k2(s, gen, len(dil))
        nbytes, flops = k2_cost(s, len(dil))
        bms, by = bound_ms(nbytes, flops)
        rows["resblock_stack"].append(dict(
            ms=cuda_ms(lambda: film_resblock_stack(*a, dil)),
            plain_ms=cuda_ms(lambda: film_resblock_stack_plain(*a, dil)),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9,
            mbytes=nbytes / 1e6))
        del x, w, b, wt, xc, a
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        import ttsx_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    signal.alarm(TIME_LIMIT_S)   # a hang ends the run without a result
    import numpy as np
    from ttsx_torch import ops
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.core.device import set_f32_numerics
    from ttsx_torch.ops import build
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo

    set_f32_numerics()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    t0 = time.time()
    emit("env", t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32_conv=torch.backends.cudnn.allow_tf32,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.time()
    libs = build.build_all()
    emit("build", t0, libraries=sorted(libs),
         ptxas={n: build.ptxas_report(n).splitlines() for n in libs})

    # -- 3. kernels against their plain versions at the stage shapes of
    # one 10 s request (batch 1) and of the serving bucket (batch 4)
    t0 = time.time()
    vc = zoo_cfg().vocoder
    dil = tuple(vc.res_dilations)
    gen = torch.Generator().manual_seed(args.seed)
    shapes = {b: stage_shapes(vc, FRAMES, b) for b in (1, MAX_BATCH)}
    checks = {b: check_kernels(shapes[b], gen, dil) for b in shapes}
    emit("kernels", t0, tolerance={"upsample": K1_TOL, "resblock_stack": K2_TOL,
                                   "rule": "abs(kernel-plain) <= atol + rtol*abs(plain)"},
         checks_by_batch=checks)
    bad = sorted({k for c in checks.values() for k, v in c.items()
                  if not all(x["ok"] for x in v)})
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # -- 4. serve the zoo model through the kernels, then the plain path
    t0 = time.time()
    srv = serve_from_zoo(device="cuda", bf16=False, max_batch=MAX_BATCH,
                         frames=FRAMES)
    load_s = time.time() - t0
    if not (srv.cfg.vocoder.use_pallas_upsample
            and srv.cfg.vocoder.use_pallas_resblock_stack):
        fail("the zoo server does not run the kernels")
    reqs = requests(srv.cfg, args.seed)
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.time()
    wavs = srv.serve_batch(reqs)
    serve_s = time.time() - t1
    launches = ops.launch_counts()
    hop = srv.cfg.vocoder.hop_length
    for w_, n_ in zip(wavs, REQUEST_FRAMES):
        if w_.shape != (n_ * hop,) or not np.isfinite(w_).all():
            fail(f"bad waveform: shape {w_.shape}, finite "
                 f"{bool(np.isfinite(w_).all())}, want {n_ * hop} samples")
        if float(np.abs(w_).max()) < SILENT:
            fail(f"silent waveform for a {n_}-frame request")
    if launches != {"upsample": 4, "resblock_stack": 4}:
        fail(f"launches on the served forward {launches}, want 4 and 4")
    plain_pipe = srv.pipe.with_vocoder_kernels(False)
    plain = SynthesisServer(plain_pipe, device="cuda", max_batch=MAX_BATCH,
                            frames=FRAMES, scale_stats=srv.scale_stats.cpu())
    ops.reset_launches()
    wavs_plain = plain.serve_batch(reqs)
    if ops.launch_counts() != {"upsample": 0, "resblock_stack": 0}:
        fail("the plain path launched a kernel")
    wav_err = max(float(np.abs(a - b).max()) for a, b in zip(wavs, wavs_plain))
    emit("serve", t0, zoo_load_s=round(load_s, 3), serve_s=round(serve_s, 3),
         requests=list(REQUEST_FRAMES),
         samples=[len(w_) for w_ in wavs],
         peak=[float(np.abs(w_).max()) for w_ in wavs],
         rms=[float(np.sqrt(np.mean(w_ ** 2))) for w_ in wavs],
         launches=launches, wav_max_abs_err_vs_plain=wav_err,
         wav_tolerance=WAV_TOL)
    if wav_err > WAV_TOL:
        fail(f"kernel path waveforms differ from the plain path by {wav_err}")

    # -- 5. timing at the stage shapes of batch 1 and of the serving bucket
    t0 = time.time()
    rows = {b: time_kernels(shapes[b], gen, dil) for b in shapes}
    # model stages and one 10 s request end to end (batch 1)
    one = SynthesisServer(srv.pipe, device="cuda", max_batch=1, frames=FRAMES,
                          scale_stats=srv.scale_stats.cpu())
    *arr, _ = one.pad_batch(reqs[:1])
    text, pros, emo, spk, sid = (torch.as_tensor(a_, device=one.device)
                                 for a_ in arr)
    p = srv.pipe
    scale = srv.scale_stats.expand(1, -1)
    with torch.inference_mode():
        mel0 = p.acoustic(text, pros, emo, speaker=spk).mel
        mel_ref = p.refiner(mel0, pros, sid, text).mel_ref
        style = p.gst(mel_ref)
        stages = {
            "acoustic_ms": cuda_ms(lambda: p.acoustic(text, pros, emo, speaker=spk)),
            "refiner_ms": cuda_ms(lambda: p.refiner(mel0, pros, sid, text)),
            "gst_ms": cuda_ms(lambda: p.gst(mel_ref)),
            "generator_kernels_ms": cuda_ms(
                lambda: p.generator(mel_ref, pros, style, emo, scale=scale)),
            "generator_plain_ms": cuda_ms(
                lambda: plain_pipe.generator(mel_ref, pros, style, emo, scale=scale)),
        }
    one.serve_batch(reqs[:1])
    e2e = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one.serve_batch(reqs[:1])
        e2e.append((time.perf_counter() - t1) * 1e3)
    emit("timing", t0, kernels_by_batch=rows, stages_batch1=stages,
         e2e_ms_10s_request=sorted(e2e)[len(e2e) // 2], e2e_ms_all=e2e,
         audio_s=FRAMES * hop / vc.sr,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the kernels line reads the main path's shapes: the serving bucket
    main_rows, main_checks = rows[MAX_BATCH], checks[MAX_BATCH]
    total = lambda name, key: (None if main_rows[name][0][key] is None
                               else sum(r[key] for r in main_rows[name]))
    meta = {
        "upsample": ("ttsx_torch/ops/csrc/upsample.cu",
                     "ttsx/ops/upsample_kernel.py:127"),
        "resblock_stack": ("ttsx_torch/ops/csrc/resblock_stack.cu",
                           "ttsx/ops/resblock_stack_kernel.py:211"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in main_checks[name]),
            ms=total(name, "ms"), plain_ms=total(name, "plain_ms"),
            bound_ms=total(name, "bound_ms"),
            bound_by=max(main_rows[name], key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=total(name, "library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
