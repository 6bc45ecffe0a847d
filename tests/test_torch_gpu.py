"""Tests that need a CUDA card (``gpu`` marker): the CUDA kernels against
their plain PyTorch versions (K1, K2 and K5 also on bf16 operands), the
zoo served through K1 and K2 in f32 and in bf16, and K1 to K5 refusing
to fall back when their library is missing (K1, K2, K4 and K5, which
are forward-only, also refuse a call that needs a gradient, and a
kernel-flagged generator under a gradient raises); the zoo's speaker
encoder and prosody predictor on the card against the CPU, and a
checkpoint of the three train blocks round-tripped on the card and onto
the CPU; the diarizer's zoo slice encoder on the card against the CPU,
its production controller end to end on the card, and batch mode with 2
workers on the card; the speaker encoder's console scripts (a card
checkpoint's EER on the card and the CPU) and its ``.pt2`` export
reloaded on the card; a world-1 NCCL mesh (``-k parallel``): an engine
step of the three blocks and the zoo's server under it equal to the same
without one, K1 and K2 counted under the mesh, and the dryrun over two
cards where there are two; the native wav loader on the card's host
(``-k native``); a parity experiment (``-k parity``), the speaker
encoder's, on the card against the CPU.

Each test skips without a card, but five: the stage 1 and 2 entry points
(trainers, zoo loaders, datasets and corpus features), the diarizer's
(slicer, embedder, overlap net and screen, GNN training, controller,
zoo loader, CLI), the observer's, the speaker encoder's console
scripts with ``ttsx-bench``, and the parity harnesses (every experiment,
``ttsx-torch-parity`` and ``record_baseline``) refuse to run without a
card unless the CPU is asked for, which runs where there is none. This file imports neither
JAX nor the JAX package, so on a machine without JAX it runs on its own:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX.)
"""
import json

import numpy as np
import pytest
import torch

from ttsx_torch import ops
from ttsx_torch.core.config import AudioConfig
from ttsx_torch.ops import build
from ttsx_torch.ops.mel_frontend import log_mel, log_mel_plain
from ttsx_torch.ops.resblock import film_resblock, film_resblock_plain
from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                           film_resblock_stack_plain)
from ttsx_torch.ops.s4_scan import s4_scan, scan_dw_conv
from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|: f32 sums in other orders
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-4)
K3_TOL = dict(rtol=1e-4, atol=1e-4)   # log-mel, as chip_smoke.py states it
K4_TOL = dict(rtol=1e-4, atol=1e-4)   # as chip_smoke.py states it
K5_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ttsx_torch.core.device import set_f32_numerics
    set_f32_numerics()
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **tol)


def _upsample_case(x, w, b, f):
    before = convt_upsample.launches
    got = convt_upsample(x, w, b, f)
    torch.cuda.synchronize()
    assert convt_upsample.launches == before + 1
    _close(got, convt_upsample_plain(x, w, b, f), **K1_TOL)


@pytest.mark.parametrize("f,cin,cout,T,B", [
    (8, 256, 128, 216, 4), (8, 128, 64, 300, 3), (2, 64, 32, 1000, 2),
    (2, 32, 16, 777, 5), (4, 20, 12, 31, 1), (2, 8, 4, 1, 1),
    # the zoo's generator stages 0 and 3 at the serving bucket (4 x 4 bands)
    (8, 256, 128, 864, 16), (2, 32, 16, 110592, 16),
    # T not a multiple of the row tile (128 rows at N >= 64, 256 at N <=
    # 32): flattened B*T rows would put two batch items in one tile, so
    # these check the zero halo at t = -1 and t = T of every item
    (8, 64, 32, 100, 3), (4, 32, 16, 130, 4), (2, 32, 16, 300, 5),
    # Cin not a multiple of 4: x is staged with 4-byte copies
    (2, 6, 8, 37, 2),
    # the prev/next split (f // 2 * Cout = 12) inside an n8 tile: the
    # warp runs both banks' offsets with B masked per column
    (2, 40, 12, 257, 3)])
def test_upsample_kernel_matches_plain(cuda, f, cin, cout, T, B):
    _upsample_case(_randn(cuda, B, T, cin),
                   _randn(cuda, 2 * f, cin, cout, scale=(2 * cin) ** -0.5),
                   _randn(cuda, cout), f)


@pytest.mark.parametrize("f,cin,cout,T,B", [
    (8, 256, 128, 96, 3), (2, 64, 32, 1000, 2)])
def test_upsample_kernel_large_inputs_f32_accurate(cuda, f, cin, cout, T, B):
    """x at 1e3 scale: K1_TOL's atol is then 1e-8 of the outputs, so the
    check is the relative 1e-5, which a single TF32 product (2^-11 per
    operand) misses and 3xTF32 holds. Inputs, taps and bias are positive,
    so no output is a cancellation near zero, where any two f32 summation
    orders differ by more than 1e-5 relative."""
    x = _randn(cuda, B, T, cin).abs() * 1e3
    w = _randn(cuda, 2 * f, cin, cout, scale=(2 * cin) ** -0.5).abs()
    _upsample_case(x, w, _randn(cuda, cout).abs(), f)


def _resblock_stack_case(args, dils):
    before = film_resblock_stack.launches
    got = film_resblock_stack(*args, dils)
    torch.cuda.synchronize()
    assert film_resblock_stack.launches == before + 1
    _close(got, film_resblock_stack_plain(*args, dils), **K2_TOL)


@pytest.mark.parametrize("B,T,C,Tf,Bf,dils", [
    (8, 1727, 128, 27, 2, (1, 3, 5)), (4, 5000, 16, 20, 1, (1, 3, 5)),
    (2, 40, 12, 40, 2, (1, 3, 5)), (3, 300, 64, 300, 3, (2,)),
    (1, 7, 32, 3, 1, (1, 3, 5, 7)),
    # the zoo's generator stages 0 and 3 at the serving bucket (4 x 4 bands)
    (16, 6912, 128, 864, 4, (1, 3, 5)), (16, 221184, 16, 864, 4, (1, 3, 5)),
    # C % 8 == 4 (channels zero-padded to 32 in K and N) and T not a
    # multiple of any row tile the launch picks
    (3, 1001, 20, 50, 1, (1, 3, 5))])
def test_resblock_stack_kernel_matches_plain(cuda, B, T, C, Tf, Bf, dils):
    n = len(dils)
    _resblock_stack_case(
        [_randn(cuda, B, T, C), _randn(cuda, Bf, Tf, 2 * n * C, scale=0.3),
         _randn(cuda, n, 3, C, 2 * C, scale=(3 * C) ** -0.5),
         _randn(cuda, n, 2 * C, scale=0.1),
         _randn(cuda, n, 3, C, C, scale=(3 * C) ** -0.5),
         _randn(cuda, n, C, scale=0.1)], dils)


@pytest.mark.parametrize("B,T,C,Tf,Bf", [(4, 1000, 128, 40, 2)])
def test_resblock_stack_kernel_large_inputs_f32_accurate(cuda, B, T, C, Tf,
                                                         Bf):
    """x at 1e3 scale at C = 128 (K = 3C = 384 a conv): K2_TOL's atol is
    then far below the outputs, so the check is the relative 1e-4 over
    six chained convs, which 3xTF32 with its partial sums flushed every
    two k8 steps has to hold. Inputs, film, weights and biases are
    positive (weights at (3C)^-1, so the stream neither grows nor decays
    much), so no output is a cancellation near zero, where any two f32
    summation orders differ by more than 1e-4 relative."""
    dils = (1, 3, 5)
    n = len(dils)
    pos = lambda *shape, scale=1.0: _randn(cuda, *shape, scale=scale).abs()
    _resblock_stack_case(
        [pos(B, T, C, scale=1e3), pos(Bf, Tf, 2 * n * C, scale=0.3),
         pos(n, 3, C, 2 * C, scale=1 / (3 * C)), pos(n, 2 * C, scale=0.1),
         pos(n, 3, C, C, scale=1 / (3 * C)), pos(n, C, scale=0.1)], dils)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = _randn(cuda, 1, 8, 6)
    with pytest.raises(ValueError, match="Cout % 4"):
        convt_upsample(x, _randn(cuda, 4, 6, 6), _randn(cuda, 6), 2)
    with pytest.raises(TypeError, match="float32"):
        convt_upsample(x.double(), _randn(cuda, 4, 6, 8).double(),
                       _randn(cuda, 8).double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        convt_upsample(x.transpose(1, 2), _randn(cuda, 4, 8, 8),
                       _randn(cuda, 8), 2)


def test_serve_from_zoo_through_kernels(cuda):
    """The zoo model on the card with both kernels: finite, non-silent
    waveforms of len * 256 samples, K1 and K2 launched 4 times each on
    one forward, and the plain path within 5e-4 of it."""
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo
    srv = serve_from_zoo(max_batch=2, frames=64, bf16=False)
    ac = srv.cfg.acoustic
    rng = np.random.default_rng(0)
    reqs = [SynthesisRequest(
        rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        np.full(ac.emotion_dim, 1 / ac.emotion_dim, np.float32),
        rng.standard_normal(ac.speaker_dim).astype(np.float32), i)
        for i, n in enumerate((64, 40))]
    ops.reset_launches()
    outs = srv.serve_batch(reqs)
    assert ops.launch_counts() == {"upsample": 4, "resblock_stack": 4,
                                   "mel_frontend": 0, "s4_scan": 0,
                                   "resblock": 0}
    for o, n in zip(outs, (64, 40)):
        assert o.shape == (n * 256,) and np.isfinite(o).all()
        assert float(np.abs(o).max()) > 1e-3
    plain = SynthesisServer(srv.pipe.with_vocoder_kernels(False),
                            max_batch=2, frames=64, bf16=False,
                            scale_stats=srv.scale_stats.cpu())
    for a, b in zip(outs, plain.serve_batch(reqs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4)


def test_serve_from_zoo_bf16_through_kernels(cuda):
    """The zoo's default server (bf16, as the reference's) on the card:
    K1 and K2 launched 4 times each, float32 stage outputs, finite and
    non-silent waveforms, the plain bf16 path within 5e-4 of it."""
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo
    srv = serve_from_zoo(max_batch=2, frames=64)
    assert srv.dtype == torch.bfloat16
    ac = srv.cfg.acoustic
    rng = np.random.default_rng(1)
    reqs = [SynthesisRequest(
        rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        np.full(ac.emotion_dim, 1 / ac.emotion_dim, np.float32),
        rng.standard_normal(ac.speaker_dim).astype(np.float32), i)
        for i, n in enumerate((64, 40))]
    ops.reset_launches()
    outs = srv.serve_batch(reqs)
    assert ops.launch_counts() == {"upsample": 4, "resblock_stack": 4,
                                   "mel_frontend": 0, "s4_scan": 0,
                                   "resblock": 0}
    for o, n in zip(outs, (64, 40)):
        assert o.shape == (n * 256,) and o.dtype == np.float32
        assert np.isfinite(o).all() and float(np.abs(o).max()) > 1e-3
    *arrays, _ = srv.pad_batch(reqs)
    out = srv.stages(*(torch.as_tensor(a, device="cuda") for a in arrays))
    assert {out.mel0.dtype, out.mel_ref.dtype, out.wav.dtype} == {
        torch.float32}
    plain = SynthesisServer(srv.pipe.with_vocoder_kernels(False),
                            max_batch=2, frames=64,
                            scale_stats=srv.scale_stats.cpu())
    assert {p.dtype for p in plain.pipe.generator.parameters()} == {
        torch.bfloat16}
    for a, b in zip(outs, plain.serve_batch(reqs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4)


@pytest.mark.parametrize("kernel", ["upsample", "resblock_stack",
                                    "resblock"])
@pytest.mark.parametrize("which", ["weights", "x"])
def test_kernels_take_bf16_operands(cuda, kernel, which):
    """K1, K2 and K5 on bf16 weights (f32 x), or on a bf16 x and FiLM:
    the kernel casts them to f32 as the reference kernels do, launches,
    and returns x's dtype; against the plain version on the same
    operands within the kernel's tolerance (a bf16 output within one bf16
    step of plain's: 2**-7 relative at most)."""
    bf = torch.bfloat16
    dt_x, dt_w = ((torch.float32, bf) if which == "weights"
                  else (bf, torch.float32))
    if kernel == "upsample":
        f, cin, cout = 8, 64, 32
        args = [_randn(cuda, 4, 100, cin).to(dt_x),
                _randn(cuda, 2 * f, cin, cout,
                       scale=(2 * cin) ** -0.5).to(dt_w),
                _randn(cuda, cout).to(dt_w)]
        fn, plain, extra, tol = convt_upsample, convt_upsample_plain, f, K1_TOL
    else:
        C = 32
        if kernel == "resblock_stack":
            n = 3
            args = [_randn(cuda, 8, 700, C).to(dt_x),
                    _randn(cuda, 2, 20, 2 * n * C, scale=0.3).to(dt_x)]
            shapes = ((n, 3, C, 2 * C), (n, 2 * C), (n, 3, C, C), (n, C))
            fn, plain, extra, tol = (film_resblock_stack,
                                     film_resblock_stack_plain, (1, 3, 5),
                                     K2_TOL)
        else:
            args = [_randn(cuda, 2, 300, C).to(dt_x)] + [
                _randn(cuda, 2, 300, C, scale=0.3).to(dt_x)
                for _ in range(2)]
            shapes = ((3, C, 2 * C), (2 * C,), (3, C, C), (C,))
            fn, plain, extra, tol = film_resblock, film_resblock_plain, 3, \
                K5_TOL
        args += [_randn(cuda, *s, scale=(3 * C) ** -0.5 if len(s) > 1
                        else 0.1).to(dt_w) for s in shapes]
    before = ops.KERNELS[kernel].launches
    with torch.no_grad():
        got = fn(*args, extra)
        want = plain(*args, extra)
    torch.cuda.synchronize()
    assert ops.KERNELS[kernel].launches == before + 1
    assert got.dtype == want.dtype == dt_x
    if dt_x == bf:
        tol = dict(tol, rtol=2.0 ** -7)
    _close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("n_fft,hop,n_mels,lengths,N", [
    (1024, 256, 80, (73728, 40000, 33075), 73728),   # the trainer's frontend
    (1024, 256, 80, (220500,), 220500),              # one 10 s clip
    (256, 64, 32, (4000, 1000), 4096),               # tests' small frontend
    (2048, 512, 128, (30000,), 30001)])
def test_mel_frontend_kernel_matches_plain(cuda, n_fft, hop, n_mels, lengths,
                                           N):
    """Zero-padded rows of noise: within K3_TOL, and the frames that see
    only the padding within 1e-5 (exact zeros on both sides)."""
    cfg = AudioConfig(n_fft=n_fft, win_length=n_fft, hop_length=hop,
                      n_mels=n_mels, mel_normalize=False)
    wav = torch.zeros(len(lengths), N)
    for i, n in enumerate(lengths):
        wav[i, :n] = torch.randn(n, generator=cuda) * 0.3
    wav = wav.cuda()
    before = log_mel.launches
    got = log_mel(wav, cfg)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    assert got.shape == (len(lengths), 1 + N // hop, n_mels)
    ref = log_mel_plain(wav, cfg)
    _close(got, ref, **K3_TOL)
    for i, n in enumerate(lengths):
        tail = (n + n_fft // 2) // hop + 1
        _close(got[i, tail:], ref[i, tail:], rtol=0, atol=1e-5)


def _log_mel_f64(wav, cfg):
    """The float64 log-mel by numpy's FFT: K3's reflect padding, window,
    filterbank and floors."""
    from ttsx_torch.dsp.stft import mel_filterbank, padded_window
    n_fft, hop = cfg.n_fft, cfg.hop_length
    x = np.pad(wav.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
               mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=1)
    spec = np.fft.rfft(frames[:, ::hop] * padded_window(cfg), axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.f_min,
                        cfg.f_max).astype(np.float64)
    return np.log(mag @ fb + 1e-5)


def _mel_signal(kind, rows, N, sr, rng):
    t = np.arange(N) / sr
    tones = np.stack([sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t)
                          for k in range(1, 6))
                      for f0 in rng.uniform(90.0, 300.0, rows)])
    noise = rng.standard_normal((rows, N))
    return {"tones": tones, "tones_over_noise": tones + 1e-3 * noise,
            "scale_1e3": 1e3 * noise, "noise": 0.3 * noise}[kind
                                                           ].astype(np.float32)


@pytest.mark.parametrize("n_fft,kind,N", [
    (1024, "tones", 40000),
    (1024, "tones_over_noise", 40000),
    (1024, "scale_1e3", 40000),
    (1024, "noise", 513),                 # N = n_fft/2 + 1, the shortest
    (1024, "tones", 24 * 256 + 100),      # T = 25: 3 CTAs of 8 frames + 1
    (256, "tones", 16000),
    (256, "noise", 129),
    (2048, "tones", 60000),
    (2048, "noise", 1025)])
def test_mel_frontend_kernel_f64_accurate(cuda, n_fft, kind, N):
    """K3 against the float64 log-mel within K3_TOL, and no farther from
    it than the plain version (dense f32) is, on tones (near-silent bands
    between the harmonics, where plain is up to 5e-2 off), tones over
    1e-3 noise, a 1e3-scale input, the shortest input and a T that is not
    a multiple of the CTA's frames; n_fft 256, 1024 and 2048."""
    sr = 16000 if n_fft == 256 else 22050
    cfg = AudioConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft,
                      hop_length=n_fft // 4,
                      n_mels={256: 32, 1024: 80, 2048: 128}[n_fft],
                      mel_normalize=False)
    wav = _mel_signal(kind, 2, N, sr, np.random.default_rng(n_fft + N))
    x = torch.as_tensor(wav).cuda()
    before = log_mel.launches
    got = log_mel(x, cfg)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    exact = _log_mel_f64(wav, cfg)
    got, plain = got.cpu().numpy(), log_mel_plain(x, cfg).cpu().numpy()
    assert got.shape == exact.shape == (2, 1 + N // (n_fft // 4), cfg.n_mels)
    np.testing.assert_allclose(got, exact, **K3_TOL)
    assert np.abs(got - exact).max() <= np.abs(plain - exact).max()


def test_mel_frontend_kernel_does_not_fall_back(cuda, monkeypatch):
    """A CUDA tensor and no kernel library: K3's wrapper raises, and the
    plain version does not run in its place."""
    import ttsx_torch.ops.mel_frontend as mel_mod

    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(mel_mod, "log_mel_plain", forbidden)
    before = log_mel.launches
    with pytest.raises(build.KernelCompileError):
        log_mel(torch.zeros(1, 4096, device="cuda"), AudioConfig())
    assert log_mel.launches == before


def _s4_case(u, a, b, c):
    before = s4_scan.launches
    got = s4_scan(u, a, b, c)
    torch.cuda.synchronize()
    assert s4_scan.launches == before + 1
    _close(got, scan_dw_conv(u, a, b, c), **K4_TOL)


@pytest.mark.parametrize("B,T,H,d,e", [
    (1, 864, 4, 70, 70), (1, 864, 4, 71, 71), (1, 864, 4, 284, 284),
    (4, 864, 4, 142, 142), (2, 300, 2, 5, 7), (1, 1, 1, 1, 3),
    (3, 33, 3, 33, 2), (1, 2000, 4, 32, 8),
    # T around the chunk (L = 32): one chunk short, exact, one and two
    # chunks plus a step; and past a group of 16 chunks (512 steps, the
    # group of a CTA of 2 channels)
    (2, 31, 2, 40, 36), (2, 32, 2, 40, 36), (2, 33, 2, 40, 36),
    (1, 65, 3, 71, 71), (2, 513, 2, 40, 36),
    # more modes than channels and the reverse (n8 tiles of modes)
    (1, 300, 2, 284, 8), (1, 300, 2, 8, 284),
    # d not a multiple of 8 (the last n8 tile of modes is partly padding)
    (2, 200, 3, 5, 16), (1, 500, 2, 70, 24),
    # CTAs of 8 channels (their CTAs number four per SM of an H100): the
    # zoo's widest layer at the serving bucket; e = 71 (4-byte copies of
    # u); T past a group of 4 chunks (128 steps)
    (4, 864, 4, 284, 284), (8, 300, 8, 71, 71), (16, 129, 8, 40, 36),
    # CTAs of 4 channels: the zoo's middle layer at batch 1 (and, above,
    # its widest at batch 1 and middle at the bucket)
    (1, 864, 4, 142, 142),
    # the most modes a CTA's shared memory holds, in CTAs of 8 channels
    # (the other widths hold more)
    (66, 40, 1, 872, 64)])
def test_s4_scan_kernel_matches_plain(cuda, B, T, H, d, e):
    """The S4 layer's decays (-linspace(1, d, d) / d per head), LayerNorm-
    scale input, a readout of scale d^-0.5; one chunk and several, T not
    a multiple of the chunk, odd e."""
    a = (-torch.linspace(1.0, d, d) / d).repeat(H, 1).cuda()
    b = torch.ones(H, d, device="cuda")
    c = _randn(cuda, H, d, e, scale=d ** -0.5)
    _s4_case(_randn(cuda, B, T, H * e), a, b, c)


def _recurrence_f64(u, a, b, c):
    """The S4 recurrence of ``scan_dw_conv`` in float64."""
    B, T, C = u.shape
    H, d = a.shape
    x = u.double().reshape(B, T, H, C // H)
    dec = torch.exp(torch.clamp(a.double(), -50.0, 50.0))[:, None, :]
    s = torch.zeros(B, H, C // H, d, dtype=torch.float64, device=u.device)
    ys = []
    for t in range(T):
        s = s * dec + x[:, t, :, :, None] * b.double()[:, None, :]
        ys.append(torch.einsum("bhed,hde->bhe", s, c.double()))
    return torch.stack(ys, dim=1).reshape(B, T, C)


@pytest.mark.parametrize("what", ["u_1e3", "slow_decay", "clipped_decay"])
def test_s4_scan_kernel_extreme_inputs_f32_accurate(cuda, what):
    """K4 at f32 accuracy (3xTF32) away from LayerNorm scale, at the zoo's
    widest layer shape (T = 864, 4 heads, d = e = 284), with signed input
    and readout: u at 1e3 scale; a slow decay (a = -1e-3: the carried
    state grows over all 864 steps); a decay clipped at -50 (a = -60:
    dec^L underflows to 0, the carry drops out). Both K4 and the plain
    version are held against the recurrence in float64: K4 within K4_TOL
    of it on the scale of the output (its largest magnitude, since an
    output that cancels to near 0 carries the rounding of the terms it
    sums, in any f32 order), and K4's largest error at most twice the
    plain version's."""
    B, T, H, d = 1, 864, 4, 284
    a = (-torch.linspace(1.0, d, d) / d).repeat(H, 1).cuda()
    c = _randn(cuda, H, d, d, scale=d ** -0.5)
    u = _randn(cuda, B, T, H * d)
    if what == "u_1e3":
        u = u * 1e3
    elif what == "slow_decay":
        a = torch.full((H, d), -1e-3, device="cuda")
    else:
        a = torch.full((H, d), -60.0, device="cuda")
    b = torch.ones(H, d, device="cuda")
    before = s4_scan.launches
    got = s4_scan(u, a, b, c)
    torch.cuda.synchronize()
    assert s4_scan.launches == before + 1
    ref = _recurrence_f64(u, a, b, c)
    err = (got.double() - ref).abs().max().item()
    plain_err = (scan_dw_conv(u, a, b, c).double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= K4_TOL["atol"] + K4_TOL["rtol"] * scale, (err, scale)
    assert err <= 2 * plain_err, (err, plain_err)


@pytest.mark.parametrize("B,T,C,dil", [
    (4, 6912, 128, 1), (4, 1000, 64, 3), (16, 777, 32, 5), (2, 40, 16, 7),
    (1, 5, 12, 2)])
def test_resblock_kernel_matches_plain(cuda, B, T, C, dil):
    args = [_randn(cuda, B, T, C), _randn(cuda, B, T, C, scale=0.3),
            _randn(cuda, B, T, C, scale=0.3),
            _randn(cuda, 3, C, 2 * C, scale=(3 * C) ** -0.5),
            _randn(cuda, 2 * C, scale=0.1),
            _randn(cuda, 3, C, C, scale=(3 * C) ** -0.5),
            _randn(cuda, C, scale=0.1)]
    before = film_resblock.launches
    got = film_resblock(*args, dil)
    torch.cuda.synchronize()
    assert film_resblock.launches == before + 1
    _close(got, film_resblock_plain(*args, dil), **K5_TOL)


def test_k4_k5_refuse_gradients_and_do_not_fall_back(cuda, monkeypatch):
    import importlib
    rb_mod = importlib.import_module("ttsx_torch.ops.resblock")
    s4_mod = importlib.import_module("ttsx_torch.ops.s4_scan")
    u, a, b, c = (_randn(cuda, 1, 40, 8), -torch.rand(2, 3).cuda(),
                  torch.ones(2, 3).cuda(), _randn(cuda, 2, 3, 4))
    blk = [_randn(cuda, 1, 40, 8), _randn(cuda, 1, 40, 8),
           _randn(cuda, 1, 40, 8), _randn(cuda, 3, 8, 16),
           _randn(cuda, 16), _randn(cuda, 3, 8, 8), _randn(cuda, 8)]
    with pytest.raises(RuntimeError, match="forward-only"):
        s4_scan(u.requires_grad_(), a, b, c)
    with pytest.raises(RuntimeError, match="forward-only"):
        film_resblock(blk[0].requires_grad_(), *blk[1:], 1)

    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a_, **k_):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(rb_mod, "film_resblock_plain", forbidden)
    monkeypatch.setattr(s4_mod, "scan_dw_conv", forbidden)
    before = (s4_scan.launches, film_resblock.launches)
    with torch.no_grad():
        with pytest.raises(build.KernelCompileError):
            s4_scan(u, a, b, c)
        with pytest.raises(build.KernelCompileError):
            film_resblock(*blk, 1)
    assert (s4_scan.launches, film_resblock.launches) == before


def test_k1_k2_refuse_gradients_and_do_not_fall_back(cuda, monkeypatch):
    """K1 and K2 raise on a call that needs a gradient (grad mode on and an
    operand that requires one), and so does a kernel-flagged generator;
    under ``torch.no_grad()`` they launch as before; with their library
    missing they raise and the plain versions never run."""
    import dataclasses
    import importlib
    from ttsx_torch.core.config import VocoderConfig
    from ttsx_torch.models.vocoder import Generator
    up_mod = importlib.import_module("ttsx_torch.ops.upsample")
    st_mod = importlib.import_module("ttsx_torch.ops.resblock_stack")
    k1 = [_randn(cuda, 2, 16, 8), _randn(cuda, 4, 8, 4), _randn(cuda, 4)]
    k2 = [_randn(cuda, 4, 32, 8), _randn(cuda, 1, 16, 48),
          _randn(cuda, 3, 3, 8, 16, scale=0.2), _randn(cuda, 3, 16),
          _randn(cuda, 3, 3, 8, 8, scale=0.2), _randn(cuda, 3, 8)]
    before = (convt_upsample.launches, film_resblock_stack.launches)
    for i in range(3):
        with pytest.raises(RuntimeError, match="forward-only"):
            convt_upsample(*[t.requires_grad_(j == i) for j, t in
                             enumerate(k1)], 2)
    for i in range(6):
        with pytest.raises(RuntimeError, match="forward-only"):
            film_resblock_stack(*[t.requires_grad_(j == i) for j, t in
                                  enumerate(k2)], (1, 3, 5))
    vc = dataclasses.replace(VocoderConfig(hidden_dim=64),
                             use_pallas_upsample=True,
                             use_pallas_resblock_stack=True)
    gen = Generator(vc).cuda()
    args = (_randn(cuda, 1, 8, 80), _randn(cuda, 1, 8, 18),
            _randn(cuda, 1, 128), torch.full((1, 6), 1 / 6).cuda())
    with pytest.raises(RuntimeError, match="forward-only"):
        gen(*args)
    assert (convt_upsample.launches, film_resblock_stack.launches) == before
    with torch.no_grad():
        _close(convt_upsample(*k1, 2), convt_upsample_plain(*k1, 2),
               **K1_TOL)
        _close(film_resblock_stack(*k2, (1, 3, 5)),
               film_resblock_stack_plain(*k2, (1, 3, 5)), **K2_TOL)
        assert gen(*args).shape == (1, 8 * 256, 1)
    assert (convt_upsample.launches, film_resblock_stack.launches) == (
        before[0] + 5, before[1] + 5)

    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a_, **k_):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(up_mod, "convt_upsample_plain", forbidden)
    monkeypatch.setattr(st_mod, "film_resblock_stack_plain", forbidden)
    with torch.no_grad():
        with pytest.raises(build.KernelCompileError):
            convt_upsample(*k1, 2)
        with pytest.raises(build.KernelCompileError):
            film_resblock_stack(*k2, (1, 3, 5))


# ------------------------------------------------ stages 1-2, checkpoints
def test_stage12_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from ttsx_torch.data.refenc_dataset import (ProsodyManifestDataset,
                                                RefEncDataset)
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.train.emotion_trainer import EmotionTrainer
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.zoo import load_prosody, load_refenc
    corpus = ToneCorpus(n_speakers=2)
    utts = corpus.utterances(1, 8)
    manifest = tmp_path / "m.json"
    manifest.write_text('{"items": []}')
    for call in (RefEncTrainer, ProsodyTrainer, EmotionTrainer, load_refenc,
                 load_prosody, lambda: corpus.features(utts),
                 lambda: RefEncDataset([("x.wav", "a")]),
                 lambda: ProsodyManifestDataset(manifest)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _zoo_mels(frames):
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.dsp.stft import mel_spectrogram
    from ttsx_torch.zoo import AUDIO
    utts = ToneCorpus(n_speakers=8, audio=AUDIO).utterances(1, frames, seed=5)
    wav = torch.as_tensor(np.stack([u.wav for u in utts]))
    return mel_spectrogram(wav, AUDIO)[:, :frames]


def test_zoo_refenc_and_prosody_card_match_cpu(cuda):
    """The zoo's speaker embedding (8 utterances, 128 frames) within 1e-5
    and the prosody predictor's outputs (864 frames) within 1e-4 of each
    output's largest magnitude, card against CPU."""
    from ttsx_torch.zoo import load_prosody, load_refenc
    mel = _zoo_mels(128)
    card, _ = load_refenc(device="cuda")
    cpu, _ = load_refenc(device="cpu")
    _close(card.embed(mel), cpu.embed(mel), rtol=0, atol=1e-5)
    mel = _zoo_mels(864)[:2]
    _, card = load_prosody(device="cuda")
    _, cpu = load_prosody(device="cpu")
    with torch.no_grad():
        got, ref = card(mel.cuda()), cpu(mel)
    for k in ref:
        _close(got[k], ref[k], rtol=0,
               atol=1e-4 * float(ref[k].abs().max()))


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A tiny three-block trainer on the card after one step: saved and
    restored into a fresh one on the card, every entry equal and on its
    device. A trainer on the CPU refuses it: a CUDA generator's state is
    not a CPU generator's."""
    from ttsx_torch.core import config as tc
    from ttsx_torch.data.synthetic import synthetic_stream
    from ttsx_torch.train.checkpoint import CheckpointMismatch, flatten
    from ttsx_torch.train.engine import UnifiedTrainer
    s4 = tc.S4Config(heads=2, norm_groups=2, causal=True)
    cfg = tc.TTSXConfig(
        audio=tc.AudioConfig(sample_rate=16000, n_fft=256, win_length=256,
                             hop_length=64),
        acoustic=tc.AcousticConfig(text_emb_dim=16, hidden_channels=16,
                                   conformer_layers=1, transformer_dim=32,
                                   num_layers=2, attention_heads=2,
                                   speaker_dim=8),
        refiner=tc.RefinerConfig(levels=1, cond_dim=16, hidden_channels=16,
                                 hsf_hidden=8, style_dim=8, beta_hidden=8,
                                 s4=s4, vq_dims=(80,), vq_codes=(16,)),
        vocoder=tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                                 disc_ch_growth=2, disc_periods=(2, 3),
                                 disc_kernel_sizes=(15,), stft_sizes=(512,)),
        train=tc.TrainConfig(warmup_steps=2, max_steps=8, val_freq=0,
                             checkpoint_freq=1, grad_accum_steps=1))
    a = UnifiedTrainer(cfg, synthetic_stream(cfg, 2, 16, n=2),
                       checkpoint_dir=str(tmp_path))
    a.train(max_steps=1)
    want = flatten(a.block_states)
    b = UnifiedTrainer(cfg, [], checkpoint_dir=str(tmp_path))
    assert b.restore_checkpoint("last")
    got = flatten(b.block_states)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device == want[k].device, k
        assert torch.equal(got[k], want[k]), k
    cpu = UnifiedTrainer(cfg, [], device="cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(CheckpointMismatch, match="rng"):
        cpu.restore_checkpoint("last")


# ------------------------------------------------------------- diarizer
DIAR_PROD = dict(min_dur=0.8, max_dur=3.0, cluster_method="spectral",
                 subsegment_s=1.0, cluster_merge_thresh=0.75)


def _dump():
    from ttsx_torch.zoo import DEFAULT_ZOO
    return np.load(DEFAULT_ZOO.parent / "diar_embs.npz", allow_pickle=True)


def test_diarizer_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from ttsx_torch.cli.main import main_diarize
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.pipeline.diarizer import (DiarizerController,
                                              GNNClusterer, SliceEmbedder)
    from ttsx_torch.pipeline.diarizer.overlap import detect_overlaps
    from ttsx_torch.pipeline.diarizer.overlap_net import (
        OverlapScreen, OverlapNet, train_overlap_net)
    from ttsx_torch.pipeline.diarizer.slicer import (dynamic_slice,
                                                     vad_probabilities)
    from ttsx_torch.zoo import load_diar_encoder
    au = AudioConfig()
    wav = np.zeros(22050, np.float32)
    e = np.eye(4, dtype=np.float32)
    for call in (lambda: vad_probabilities(wav, au),
                 lambda: dynamic_slice(wav, au), SliceEmbedder,
                 load_diar_encoder, DiarizerController,
                 lambda: train_overlap_net(ToneCorpus(n_speakers=2), au,
                                           steps=1, n_train=1),
                 lambda: OverlapScreen(au, OverlapNet().state_dict()),
                 lambda: GNNClusterer().train(e, np.array([0, 0, 1, 1])),
                 lambda: detect_overlaps(wav, au, [(0.0, 0.4), (0.5, 1.0)],
                                         np.array([0, 1]), e[:2]),
                 lambda: main_diarize(["x.wav", "--output-dir",
                                       str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_diarizer_embedder_card_matches_cpu(cuda):
    """The zoo's slice encoder on the dump's 81 windows, card vs CPU."""
    from ttsx_torch.zoo import load_diar_encoder
    d = _dump()
    wins = [tuple(w) for w in d["win_plain"]]
    got = load_diar_encoder(device="cuda").extract(d["wav"], wins)
    want = load_diar_encoder(device="cpu").extract(d["wav"], wins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _diar_truth(d):
    return [(float(s), float(e), str(k)) for s, e, k in
            zip(d["truth_start"], d["truth_end"], d["truth_spk"])]


def test_diarizer_controller_on_card(cuda, tmp_path):
    """The production controller with the zoo encoder on the card, on the
    dump's stream: status ok, the recorded DER (0.27676 strict, 0.17144
    with a 250 ms collar), 5 speakers and 60 segments."""
    import json
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.eval.metrics import diarization_error_rate
    from ttsx_torch.pipeline.diarizer import DiarizerController
    from ttsx_torch.zoo import AUDIO, load_diar_encoder
    d = _dump()
    wp = tmp_path / "hard.wav"
    write_wav(wp, d["wav"].astype(np.float32), AUDIO.sample_rate)
    ctl = DiarizerController(AUDIO, embedder=load_diar_encoder(),
                             **DIAR_PROD)
    res = ctl.diarize_single(str(wp), str(tmp_path / "out"))
    log = json.loads((tmp_path / "out/diarization_log.json").read_text())
    assert log["status"] == "ok" and res
    hyp = [(s, e, k) for (s, e), k in zip(res["slices"], res["speakers"])]
    hyp += [(s, e, k) for s, e, a, b, _c in res["overlap_speakers"]
            for k in (a, b)]
    truth = _diar_truth(d)
    assert round(diarization_error_rate(truth, hyp), 5) == 0.27676
    assert round(diarization_error_rate(truth, hyp, collar=0.25),
                 5) == 0.17144
    assert len(set(res["speakers"])) == 5 and len(res["slices"]) == 60


def test_diarizer_batch_two_workers_on_card(cuda, tmp_path):
    """Batch mode, 2 worker threads sharing the zoo embedder and the ReID
    memory on the card: both jobs (two 20 s parts of the stream) end ok
    with segments."""
    import json
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.pipeline.diarizer import DiarizerController
    from ttsx_torch.zoo import AUDIO, load_diar_encoder
    d = _dump()
    sr = AUDIO.sample_rate
    paths = []
    for i, start in enumerate((0, 40)):
        p = tmp_path / f"part{i}.wav"
        write_wav(p, d["wav"][start * sr:(start + 20) * sr].astype(
            np.float32), sr)
        paths.append(str(p))
    ctl = DiarizerController(AUDIO, embedder=load_diar_encoder(),
                             **DIAR_PROD)
    res = ctl.diarize_batch(paths, str(tmp_path / "out"), workers=2)
    assert sorted(res) == ["part0", "part1"]
    for job, r in res.items():
        log = json.loads((tmp_path / "out" / job /
                          "diarization_log.json").read_text())
        assert log["status"] == "ok" and r and r["slices"], job


# ------------------------------------------------------------- observer
def test_observer_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from ttsx_torch.cli.main import main_observer
    from ttsx_torch.pipeline import (ASRService, ObserverPipeline,
                                     ProsodyExtractStage, watch)
    from ttsx_torch.pipeline import services
    wav = np.zeros(22050, np.float32)
    for call in (ObserverPipeline, ASRService, ProsodyExtractStage,
                 lambda: watch(str(tmp_path), str(tmp_path / "out")),
                 lambda: services.asr_transcribe(wav, 22050),
                 lambda: services.ssl_features(wav[None], 22050),
                 lambda: services.vad_probs(wav, 22050),
                 lambda: main_observer(["--job", "x.wav", "--output-dir",
                                        str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_observer_job_on_card(cuda, tmp_path):
    """One observer job on the card (an 8 s two-speaker stream, a small
    untrained slice encoder, the ``ScriptedText`` transcriber, a small
    prosody predictor): ``done``, every stage ``ok``, speakers, device
    memory in every resource snapshot, no kernel launched; the same job
    on the CPU names the same speakers and writes the same tier-2
    labels."""
    import json
    import uuid
    from ttsx_torch.core.config import ProsodyConfig, RefEncConfig, S4Config
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.models.prosody import ProsodyPredictor
    from ttsx_torch.pipeline import ObserverPipeline, ReIDMemory
    from ttsx_torch.pipeline.asr import ASRService, ScriptedText
    from ttsx_torch.pipeline.diarizer import (DiarizerController,
                                              SliceEmbedder)
    au = AudioConfig()
    wav, _, _ = ToneCorpus(n_speakers=2, audio=au, seed=3).dialogue_hard(
        [0, 1], 6, noise_db=20.0, overlap_prob=0.4, seed=3)
    wp = tmp_path / "two.wav"
    write_wav(wp, wav.astype(np.float32), au.sample_rate)
    pcfg = ProsodyConfig(audio=AudioConfig(mel_normalize=False), cond_dim=32,
                         n_layers=2, s4=S4Config(heads=2, norm_groups=4))
    torch.manual_seed(0)
    pred = ProsodyPredictor(pcfg)
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        n = iter(range(1, 100))
        uuid4 = uuid.uuid4
        uuid.uuid4 = lambda: type("U", (), {"hex": f"{next(n):08x}"})()
        try:
            emb = SliceEmbedder(au, RefEncConfig(speaker_dim=32,
                                                 ecapa_channels=32,
                                                 num_speakers=2),
                                device=dev)
            ctl = DiarizerController(au, embedder=emb, device=dev,
                                     memory=ReIDMemory(match_threshold=0.9))
            asr = ASRService(transcribe_fn=ScriptedText(ASRService(
                audio=au, device=dev)), audio=au, device=dev)
            pipe = ObserverPipeline(au, ctl, asr, prosody_params=pred.to(dev),
                                    device=dev)
            summary = pipe.run_job(str(wp), str(tmp_path / dev))
        finally:
            uuid.uuid4 = uuid4
        assert summary["status"] == "done" and summary["speakers"], summary
        assert set(summary["stages"].values()) == {"ok"}
        out[dev] = summary
    assert all(r["device_bytes_in_use"] > 0
               for r in out["cuda"]["resources"])
    assert out["cuda"]["speakers"] == out["cpu"]["speakers"]
    for spk in out["cpu"]["speakers"]:
        tags = [json.loads((tmp_path / dev / "emotion_tags" / spk /
                            "tier2_tags.json").read_text())["tags"]
                for dev in ("cuda", "cpu")]
        assert [t["label"] for t in tags[0]] == [t["label"] for t in tags[1]]
    assert not any(ops.launch_counts().values())


# ------------------------------------------- the speaker encoder's scripts
def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_refenc_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from ttsx_torch.cli.main import (main_bench, main_refenc_eer,
                                     main_refenc_fuse, main_refenc_latency,
                                     main_refenc_train)
    from ttsx_torch.eval import microbenchmarks
    lst = tmp_path / "list.tsv"
    lst.write_text("x.wav\ta\n")
    for call in (lambda: main_refenc_train([str(lst)]),
                 lambda: main_refenc_eer([str(lst), "--allow-random"]),
                 lambda: main_refenc_latency([]),
                 lambda: main_refenc_fuse(["--out",
                                           str(tmp_path / "x.pt2")]),
                 lambda: main_bench([]), microbenchmarks):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "x.pt2").exists()


def test_refenc_eer_of_a_card_checkpoint_on_card_and_cpu(cuda, tmp_path,
                                                         capsys):
    """refenc-train on the card (2 steps, batch 2, 0.8 s crops of a
    FormantCorpus tree), then refenc-eer of its checkpoint on the card and
    on the CPU: the same EER, embeddings within 1e-5."""
    from ttsx_torch.cli.main import main_refenc_eer, main_refenc_train
    from ttsx_torch.cli.refenc import embed_files, load_encoder
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.data import load_file_list, write_wav
    from ttsx_torch.data.formantcorpus import FormantCorpus
    corpus = FormantCorpus(n_speakers=3, audio=AudioConfig())
    lines = []
    for i, u in enumerate(corpus.utterances(3, 120, seed=4)):
        path = tmp_path / f"u{i}.wav"
        write_wav(path, u.wav, 22050)
        lines.append(f"{path}\tspk{u.speaker}")
    lst = tmp_path / "list.tsv"
    lst.write_text("\n".join(lines))
    run = _cli_json(main_refenc_train, [
        str(lst), "--max-steps", "2", "--batch", "2", "--crop-seconds", "0.8",
        "--workers", "1", "--output-dir", str(tmp_path / "run")], capsys)
    assert run["steps"] == 2 and run["n_speakers"] == 3
    ckpt = str(tmp_path / "run" / "checkpoints")
    eer = {dev: _cli_json(main_refenc_eer, [str(lst), "--checkpoint", ckpt,
                                            "--device", dev], capsys)
           for dev in ("cuda", "cpu")}
    assert eer["cuda"] == eer["cpu"] and eer["cpu"]["n"] == 9
    items = load_file_list(lst)
    embs = [embed_files(load_encoder(RefEncConfig(), dev, 0, ckpt), items,
                        dev)[0] for dev in ("cuda", "cpu")]
    assert float(np.abs(embs[0] - embs[1]).max()) <= 1e-5


def test_pt2_export_reloads_on_card(cuda, tmp_path):
    """The full-width encoder exported on the card reloads there and gives
    the eager encoder's embedding within 1e-5."""
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.cli.refenc import load_encoder
    from ttsx_torch.eval import export_reference_encoder, load_pt2
    enc = load_encoder(RefEncConfig(), "cuda", 3)
    path = tmp_path / "enc.pt2"
    assert len(export_reference_encoder(enc, path)) == path.stat().st_size
    program = load_pt2(path)
    mel = _randn(cuda, 1, 172, 80)
    with torch.no_grad():
        got, want = program(mel), enc(mel)
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-5


# ---------------------------------------------------------------- parallel
@pytest.fixture
def nccl_world1(cuda):
    """A world-1 NCCL process group on card 0 for the test."""
    import torch.distributed as dist
    from ttsx_torch.parallel.spawn import free_port
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_parallel_world1_engine_and_server_equal_meshless(nccl_world1):
    """One engine step of the three blocks (the dryrun's tiny config)
    under a world-1 NCCL mesh equals the step without it; the zoo's f32
    server under the mesh launches K1 and K2 4 times each and gives the
    mesh-less server's waveforms."""
    from ttsx_torch.core.mesh import make_mesh
    from ttsx_torch.data.synthetic import synthetic_batch
    from ttsx_torch.parallel.dryrun import tiny_cfg
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    from ttsx_torch.train.checkpoint import flatten
    from ttsx_torch.train.engine import UnifiedTrainer
    from ttsx_torch.zoo import serve_from_zoo
    mesh = make_mesh(device="cuda")
    assert mesh.shape == (1, 1) and mesh.device == torch.device("cuda", 0)
    cfg = tiny_cfg()
    batch = synthetic_batch(cfg, batch=2, frames=8, seed=1)
    runs = []
    for m in (mesh, None):
        tr = UnifiedTrainer(cfg, iter([]), mesh=m)
        metrics = tr.train_step(batch)
        metrics.pop("step_time_s")
        runs.append((metrics, flatten(tr.block_states)))
    assert runs[0][0].keys() == runs[1][0].keys()
    for k, v in runs[1][0].items():
        assert runs[0][0][k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
    for k, v in runs[1][1].items():
        if v.is_floating_point():
            _close(runs[0][1][k], v, rtol=1e-6, atol=1e-7)

    srv = serve_from_zoo(max_batch=2, frames=64, bf16=False)
    meshed = SynthesisServer(srv.pipe, max_batch=2, frames=64, bf16=False,
                             scale_stats=srv.scale_stats.cpu(), mesh=mesh)
    ac = srv.cfg.acoustic
    rng = np.random.default_rng(0)
    reqs = [SynthesisRequest(
        rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        np.full(ac.emotion_dim, 1 / ac.emotion_dim, np.float32),
        rng.standard_normal(ac.speaker_dim).astype(np.float32), i)
        for i, n in enumerate((64, 40))]
    ops.reset_launches()
    outs = meshed.serve_batch(reqs)
    assert ops.launch_counts() == {"upsample": 4, "resblock_stack": 4,
                                   "mel_frontend": 0, "s4_scan": 0,
                                   "resblock": 0}
    for a, b in zip(outs, srv.serve_batch(reqs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_parallel_dryrun_on_two_cards(cuda):
    """``dryrun_multichip(2)``: NCCL over two cards, equal to one rank."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from ttsx_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2)
    assert out["ok"] and out["world"] == 2


# ------------------------------------------------------------------ native
def test_native_loader_on_card_host(cuda, tmp_path):
    """The native decoder and the pthreads prefetcher build and run on the
    card's host: ``WavBatchLoader`` takes the native executor by default."""
    from ttsx_torch.data import WavBatchLoader, read_wav, write_wav
    from ttsx_torch.native import load
    items = []
    for i in range(3):
        p = tmp_path / f"f{i}.wav"
        write_wav(p, np.full(3000, (i + 1) / 10.0, np.float32), 16000)
        items.append((str(p), i))
    wav, sr = read_wav(items[0][0])
    native, _ = load("_ttsx_wavio").read_wav(items[0][0])
    assert sr == 16000 and np.array_equal(wav, native)
    with WavBatchLoader(items, crop=1024, batch=2, workers=1) as loader:
        assert loader.is_native
        w, lab = loader.next(10000)
    assert w.shape == (2, 1024) and lab.shape == (2,)


# ------------------------------------------------------------------ parity
def test_parity_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from ttsx_torch.eval import parity_aux
    from ttsx_torch.eval.record_baseline import record
    for name, run in parity_aux.EXPERIMENTS.items():
        with pytest.raises(RuntimeError, match="cuda"):
            run()
    out = tmp_path / "parity.json"
    with pytest.raises(RuntimeError, match="cuda"):
        parity_aux.main(["--exp", "vocoder", "--out", str(out)])
    with pytest.raises(RuntimeError, match="cuda"):
        record()
    assert not out.exists()


def test_parity_refenc_on_card_and_cpu(cuda):
    """``refenc_parity`` draws nothing but its numpy batches, so its
    readouts on the card are the CPU's: the random-weight and trained EERs
    within one pair's share of the pairs, the last loss within 1e-4
    relative."""
    from ttsx_torch.eval.parity_refenc import refenc_parity
    kw = dict(n_speakers=4, utts_train=2, utts_eval=2, frames=32, steps=3,
              batch=8, eval_every=1)
    card, cpu = refenc_parity(**kw), refenc_parity(**kw, device="cpu")
    n = cpu["eval_utts"]
    pair = 2.0 / (n * (n - 1))
    for k in ("eer_random_weights", "eer", "eer_final"):
        assert abs(card[k] - cpu[k]) <= pair + 1e-9, k
    np.testing.assert_allclose(card["final_loss"], cpu["final_loss"],
                               rtol=1e-4)
    assert card["steps"] == cpu["steps"] == 3
