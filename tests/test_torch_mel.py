"""The algorithm of the mel-frontend kernel K3 on the CPU.

``fft_log_mel`` writes K3's decomposition out in float64 torch: the
reflect-padded windowed frame packed into z[m] = x[2m] + i x[2m+1], the
Stockham passes in the kernel's order (``radix_plan``), the split step to
the n_fft/2 + 1 bins, the filterbank by each mel's first bin and packed
weights. It is held against the Pallas kernel in interpret mode (as
tests/test_ops.py runs it) and against a float64 log-mel by numpy's FFT.
Also the host tables K3 reads and its wrapper's geometry check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close

from ttsx.core.config import AudioConfig as JAudio
from ttsx_torch.core.config import AudioConfig
from ttsx_torch.dsp.stft import mel_filterbank, padded_window
from ttsx_torch.ops.mel_frontend import (FFT_SIZES, LOG_EPS, MAG_FLOOR,
                                         check_geometry, filterbank_taps,
                                         kernel_tables, radix_plan, twiddles)

# tests/test_ops.py's small frontend: 16 kHz, n_fft 256, hop 64, 32 mels
SMALL = dict(sample_rate=16000, n_fft=256, win_length=256, hop_length=64,
             n_mels=32, mel_normalize=False)
K3_TOL = 1e-4   # |K3 - ref| <= 1e-4 + 1e-4 |ref|, as chip_smoke.py states it


def fft_log_mel(wav: np.ndarray, cfg: AudioConfig) -> torch.Tensor:
    """wav [B, N] -> log-mel [B, T, n_mels], float64, step by step as K3
    computes it from its host tables."""
    tab = {k: torch.as_tensor(v) for k, v in kernel_tables(cfg).items()}
    n_fft, hop, M = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    x = torch.as_tensor(wav).double()
    B, N = x.shape
    T = 1 + N // hop
    s = torch.arange(T)[:, None] * hop + torch.arange(n_fft)[None, :] - M
    s = torch.where(s < 0, -s, torch.where(s >= N, 2 * (N - 1) - s, s))
    frame = x[:, s] * tab["window"]                        # [B, T, n_fft]
    z = torch.complex(frame[..., 0::2], frame[..., 1::2])  # [B, T, M]
    table = torch.complex(tab["twiddle"][:, 0], tab["twiddle"][:, 1])
    ns, off = 1, 0
    for R in radix_plan(n_fft):
        j, r = torch.arange(M // R)[:, None], torch.arange(R)[None, :]
        v = z[..., j + r * (M // R)]
        if ns > 1:   # W_(ns R)^(s r) at [s][r - 1]
            w = table[off:off + ns * (R - 1)].reshape(ns, R - 1)
            v = v * torch.cat([torch.ones_like(w[:, :1]), w], 1)[j % ns, r]
            off += ns * (R - 1)
        dft = torch.exp(-2j * np.pi * torch.outer(
            torch.arange(R), torch.arange(R)).double() / R)
        out = torch.empty_like(z)
        out[..., (j // ns) * ns * R + j % ns + r * ns] = v @ dft
        z, ns = out, ns * R
    assert ns == M
    tw = table[off:]   # e^(-2 pi i k / n_fft), k = 0..M/2
    assert tw.shape[0] == M // 2 + 1
    k = torch.arange(M // 2 + 1)
    a, b = z[..., k], z[..., (M - k) % M].conj()
    e, g = (a + b) / 2, tw[k] * (a - b) / 2
    mag = torch.empty(B, T, M + 1, dtype=torch.float64)
    for idx, X in ((k, e - 1j * g), (M - k, e.conj() - 1j * g.conj())):
        mag[..., idx] = torch.sqrt(X.real ** 2 + X.imag ** 2 + MAG_FLOOR)
    mel = torch.stack([
        mag[..., f:f + o1 - o0] @ tab["taps"][o0:o1]
        for f, o0, o1 in zip(tab["first"].tolist(), tab["offset"][:-1].tolist(),
                             tab["offset"][1:].tolist())], -1)
    return torch.log(mel + LOG_EPS)


def log_mel_f64(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """The float64 log-mel by numpy's FFT: K3's reflect padding, window,
    filterbank and floors."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    x = np.pad(wav.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
               mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=1)
    spec = np.fft.rfft(frames[:, ::hop] * padded_window(cfg), axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + MAG_FLOOR)
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.f_min,
                        cfg.f_max).astype(np.float64)
    return np.log(mag @ fb + LOG_EPS)


def _noise(seed, *shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _tones(seed, rows, n, sr):
    """Five-harmonic tones at 90-300 Hz, as chip_smoke.py's tone rows."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return np.stack([sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t)
                         for k in range(1, 6))
                     for f0 in rng.uniform(90.0, 300.0, rows)]
                    ).astype(np.float32)


def test_k3_fft_decomposition_matches_pallas():
    """Noise at the small frontend, zero-padded rows of mixed lengths
    included: K3's float64 decomposition against the dense f32 Pallas
    kernel within K3_TOL."""
    from ttsx.ops.mel_kernel import mel_frontend_pallas
    cfg = AudioConfig(**SMALL)
    wav = np.zeros((3, 4000), np.float32)
    for i, n in enumerate((4000, 2500, 1200)):
        wav[i, :n] = _noise(i, n)
    ref = mel_frontend_pallas(jnp.asarray(wav), JAudio(**SMALL),
                              interpret=True)
    got = fft_log_mel(wav, cfg)
    assert got.shape == ref.shape == (3, 1 + 4000 // 64, 32)
    close(got, ref, K3_TOL, K3_TOL)


@pytest.mark.parametrize("signal", ["tones", "noise", "tones_over_noise"])
def test_k3_fft_decomposition_matches_float64_at_trainer_frontend(signal):
    """The trainer's frontend (22.05 kHz, 1024 / 256 / 80 mels): within
    1e-9 of numpy's float64 log-mel, on the near-silent bands between a
    tone's harmonics too, where dense f32 sums miss by ~1e-2."""
    cfg = AudioConfig(mel_normalize=False)
    wav = {"tones": lambda: _tones(0, 2, 11025, 22050),
           "noise": lambda: _noise(1, 2, 11025),
           "tones_over_noise": lambda: _tones(2, 2, 11025, 22050)
           + _noise(3, 2, 11025, scale=1e-3)}[signal]()
    got = fft_log_mel(wav, cfg).numpy()
    ref = log_mel_f64(wav, cfg)
    assert got.shape == ref.shape == (2, 1 + 11025 // 256, 80)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n_fft", FFT_SIZES)
def test_k3_fft_decomposition_every_radix_plan(n_fft):
    """Each n_fft K3 takes (radix plans 8-4, 8-8, 8-16, 8-8-4, 8-8-8,
    8-8-16), at hop n_fft/4, on noise and on the shortest input (n_fft/2
    + 1 samples, reflected at both ends): within 1e-9 of numpy."""
    cfg = AudioConfig(sample_rate=16000, n_fft=n_fft, win_length=n_fft,
                      hop_length=n_fft // 4, n_mels=32, mel_normalize=False)
    for wav in (_noise(n_fft, 2, 3 * n_fft + 17), _noise(5, 1, n_fft // 2 + 1)):
        np.testing.assert_allclose(fft_log_mel(wav, cfg).numpy(),
                                   log_mel_f64(wav, cfg), rtol=0, atol=1e-9)


def test_k3_radix_plan_covers_the_fft():
    """Passes of radix 8, the last of 16 or 4: their product is n_fft/2,
    and each divides the 16 points a thread holds."""
    assert {n: radix_plan(n) for n in FFT_SIZES} == {
        64: (8, 4), 128: (8, 8), 256: (8, 16), 512: (8, 8, 4),
        1024: (8, 8, 8), 2048: (8, 8, 16)}


@pytest.mark.parametrize("n_fft", [256, 1024, 2048])
def test_k3_twiddles_are_float64(n_fft):
    """The per-pass factors W_(Ns R)^(s r) at [s][r - 1], then the split
    step's e^(-2 pi i k / n_fft), k <= n_fft/4, made in float64: within
    1e-15 of numpy's complex exponential, which rounds the angle in
    another order (f32 values widened would be ~1e-8 off). So is the
    window."""
    tw = twiddles(n_fft)
    ref, ns = [], 1
    for p, R in enumerate(radix_plan(n_fft)):
        if p:
            ref += [np.exp(-2j * np.pi * s * r / (ns * R))
                    for s in range(ns) for r in range(1, R)]
        ns *= R
    ref += list(np.exp(-2j * np.pi * np.arange(n_fft // 4 + 1) / n_fft))
    assert tw.dtype == np.float64 and tw.shape == (len(ref), 2)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], ref, rtol=0,
                               atol=1e-15)
    assert np.abs(tw - tw.astype(np.float32)).max() > 1e-9
    win = kernel_tables(AudioConfig(n_fft=n_fft, win_length=n_fft))["window"]
    np.testing.assert_array_equal(
        win, padded_window(AudioConfig(n_fft=n_fft, win_length=n_fft)))
    assert win.dtype == np.float64
    assert np.abs(win - win.astype(np.float32)).max() > 1e-9


@pytest.mark.parametrize("n_fft,n_mels,sr,f_max", [
    (1024, 80, 22050, 8000.0), (256, 32, 16000, 8000.0)])
def test_k3_filterbank_taps_cover_the_nonzeros(n_fft, n_mels, sr, f_max):
    """Each mel's range [first, first + count) holds exactly its nonzero
    bins, and the packed weights are the filterbank's own (widened)."""
    fb = mel_filterbank(sr, n_fft, n_mels, 0.0, f_max)
    first, offset, taps = filterbank_taps(fb)
    assert taps.dtype == np.float64 and first.dtype == offset.dtype == np.int32
    assert offset[0] == 0 and offset[-1] == taps.size == np.count_nonzero(fb)
    dense = np.zeros_like(fb, np.float64)
    for m in range(n_mels):
        rng = slice(first[m], first[m] + offset[m + 1] - offset[m])
        assert (fb[rng, m] != 0).all()
        dense[rng, m] = taps[offset[m]:offset[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    if n_fft == 1024:   # the trainer's: 729 taps, at most 24 bins a mel
        assert taps.size == 729 and np.diff(offset).max() == 24


@pytest.mark.parametrize("kw,ok", [
    (dict(n_fft=1000, win_length=1000), False),
    (dict(n_fft=4096, win_length=4096), False),
    (dict(n_fft=32, win_length=32, hop_length=8), False),
    (dict(n_fft=1024, win_length=1025), False),
    (dict(n_fft=256, win_length=256, hop_length=257), False),
    (dict(n_fft=1024, win_length=800), True),
    (dict(n_fft=64, win_length=64, hop_length=64), True),
    (dict(n_fft=2048, win_length=2048, hop_length=512), True)])
def test_k3_geometry_check(kw, ok):
    """K3 takes a power-of-two n_fft from 64 to 2048, win_length <= n_fft
    and hop <= n_fft, and the wrapper raises on anything else."""
    cfg = AudioConfig(**kw)
    if ok:
        check_geometry(cfg)
    else:
        with pytest.raises(ValueError, match="power-of-two n_fft"):
            check_geometry(cfg)
