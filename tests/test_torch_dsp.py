"""The port's DSP path against ``ttsx`` on the CPU: the STFT / mel plain
versions, the plain version of the mel-frontend kernel K3 against the
Pallas kernel in interpret mode (as tests/test_ops.py runs it), the
silent-frame gap between K3 and the plain ``|rfft|`` mel, f0 / energy,
and K3's wrapper refusing to fall back for a CUDA tensor."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close, t

from ttsx.core.config import AudioConfig as JAudio
from ttsx_torch.core.config import AudioConfig
from ttsx_torch.ops import build
from ttsx_torch.ops.mel_frontend import log_mel, log_mel_plain, mel_frontend
import ttsx_torch.ops.mel_frontend as mel_mod

# tests/test_ops.py's small frontend: 16 kHz, n_fft 256, hop 64, 32 mels
SMALL = dict(sample_rate=16000, n_fft=256, win_length=256, hop_length=64,
             n_mels=32)


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return AudioConfig(**kw), JAudio(**kw)


def _noise(seed, *shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_stft_and_mel_spectrogram_match_reference(normalize):
    """f32 rFFTs in two libraries: 1e-4 on the magnitude, 1e-4 on the
    log-mel (5e-4 normalised: division by per-bin stds)."""
    from ttsx.dsp import stft as jstft
    from ttsx_torch.dsp import stft
    cfg, jcfg = _cfgs(mel_normalize=normalize)
    wav = _noise(0, 2, 3000)
    np.testing.assert_array_equal(
        stft.mel_filterbank(16000, 256, 32, 0.0, 8000.0),
        jstft.mel_filterbank(16000, 256, 32, 0.0, 8000.0))
    close(stft.frame_signal(t(wav), 256, 64),
          jstft.frame_signal(jnp.asarray(wav), 256, 64), 0, 0)
    close(stft.stft_magnitude(t(wav), 256, 64),
          jstft.stft_magnitude(jnp.asarray(wav), 256, 64), 1e-4, 1e-4)
    tol = 5e-4 if normalize else 1e-4
    close(stft.mel_spectrogram(t(wav), cfg),
          jstft.mel_spectrogram(jnp.asarray(wav), jcfg), tol, tol)


def test_k3_plain_matches_pallas_on_noise():
    """Tolerance of tests/test_ops.py: 2e-3 abs / 1e-3 rel on the log-mel."""
    from ttsx.ops.mel_kernel import mel_frontend_pallas
    cfg, jcfg = _cfgs(mel_normalize=False)
    wav = _noise(0, 2, 4000)
    ref = mel_frontend_pallas(jnp.asarray(wav), jcfg, interpret=True)
    got = log_mel(t(wav), cfg)
    assert got.shape == ref.shape == (2, 1 + 4000 // 64, 32)
    close(got, ref, 1e-3, 2e-3)


def test_k3_plain_matches_pallas_on_zero_padded_batch():
    """A collated batch: wavs of mixed lengths zero-padded to one bucket.
    Frames that see only the padding agree within 1e-5 (exact zeros on
    both sides), the rest within 2e-3 / 1e-3."""
    from ttsx.ops.mel_kernel import mel_frontend_pallas
    cfg, jcfg = _cfgs(mel_normalize=False)
    lengths = (4096, 2500, 1200)
    wav = np.zeros((3, 4096), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = _noise(i, n)
    ref = np.asarray(mel_frontend_pallas(jnp.asarray(wav), jcfg,
                                         interpret=True))
    got = log_mel(t(wav), cfg).numpy()
    close(got, ref, 1e-3, 2e-3)
    for i, n in enumerate(lengths[1:], 1):
        silent = (n + 128) // 64 + 1   # first frame past the wav's reach
        assert silent < got.shape[1]
        np.testing.assert_allclose(got[i, silent:], ref[i, silent:],
                                   rtol=0, atol=1e-5)


def test_k3_normalized_matches_pallas():
    """Tolerance of tests/test_ops.py's normalised case: 5e-3 / 1e-2."""
    from ttsx.ops.mel_kernel import mel_frontend_pallas
    cfg, jcfg = _cfgs(mel_normalize=True)
    wav = _noise(1, 1, 3000, scale=1.0)
    ref = mel_frontend_pallas(jnp.asarray(wav), jcfg, interpret=True)
    close(mel_frontend(t(wav), cfg), ref, 1e-2, 5e-3)


def test_k3_reads_higher_than_mel_spectrogram_on_silent_frames():
    """The collator's route (K3) floors the magnitude at sqrt(1e-12); the
    plain |rfft| mel is 0 on an all-zero frame. At the trainer's frontend
    (22.05 kHz, n_fft 1024, 80 mels, f_max 8 kHz, filterbank column sums
    1.06-12.19) K3 reads log(1 + 0.1 * colsum) = 0.10-0.80 higher per mel
    bin there; on frames with signal the two agree within 2e-3."""
    from ttsx.dsp.stft import mel_spectrogram as jmel
    cfg = AudioConfig(mel_normalize=False)
    wav = np.zeros((1, 22050), np.float32)
    wav[0, :11025] = _noise(2, 11025)
    k3 = log_mel(t(wav), cfg).numpy()[0]
    ref = np.asarray(jmel(jnp.asarray(wav), JAudio(mel_normalize=False)))[0]
    gap = k3[-10:] - ref[-10:]                      # all-zero frames
    assert np.allclose(gap, gap[0], atol=1e-5)
    assert 0.10 < gap[0].min() < 0.11 and 0.79 < gap[0].max() < 0.80
    np.testing.assert_allclose(k3[:40], ref[:40], rtol=1e-3, atol=2e-3)


def test_extract_f0_energy_matches_reference():
    """Tones and noise: energy within 1e-5, voicing and f0 equal (the
    autocorrelation peaks of these signals are far from ties)."""
    from ttsx.dsp.features import extract_f0_energy as jf0
    from ttsx_torch.dsp.features import extract_f0_energy
    cfg, jcfg = _cfgs()
    n = np.arange(4000) / 16000
    wav = np.stack([0.5 * np.sin(2 * np.pi * 220 * n),
                    0.3 * np.sin(2 * np.pi * 130 * n) * (n < 0.12),
                    _noise(3, 4000, scale=0.2)]).astype(np.float32)
    f0, en, voiced = extract_f0_energy(t(wav), cfg)
    rf0, ren, rvoiced = jf0(jnp.asarray(wav), jcfg)
    close(en, ren, 1e-5, 1e-5)
    np.testing.assert_array_equal(voiced.numpy(), np.asarray(rvoiced))
    close(f0, rf0, 1e-6, 1e-4)
    assert voiced[0].float().mean() > 0.9          # the 220 Hz tone


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path
    of a wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_k3_cuda_tensor_without_kernel_raises(monkeypatch):
    """With the kernel library unavailable K3's wrapper raises; it never
    runs the plain version for a CUDA tensor."""
    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(mel_mod, "log_mel_plain", forbidden)
    wav = torch.Tensor._make_subclass(_CudaLooking, t(_noise(4, 2, 3000)))
    before = log_mel.launches
    with pytest.raises(build.KernelCompileError):
        log_mel(wav, AudioConfig(**SMALL))
    with pytest.raises(ValueError, match="unsupported device"):
        log_mel(torch.empty(1, 3000, device="meta"), AudioConfig(**SMALL))
    assert log_mel.launches == before
