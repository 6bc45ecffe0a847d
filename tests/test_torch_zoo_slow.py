"""Full-width parity on the checked-in zoo: the trained model through
``ttsx`` (JAX on the CPU) and through ``ttsx_torch`` (CPU, both kernel
flags on, so the generator takes the kernels' plain versions).

Marked slow: the reference compiles the full-width chain on the CPU,
which takes minutes. Stated tolerance: waveform within 1e-4 absolute,
mels within 1e-3 absolute.
"""
import jax
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow


def test_zoo_text_to_waveform_matches_reference():
    from ttsx.train.slim_export import load_slim_meta
    from ttsx.zoo import DEFAULT_ZOO, load_pipeline as j_load
    from ttsx_torch.zoo import load_pipeline
    jpipe, params = j_load()
    params.pop("_missing")
    pipe, meta = load_pipeline(device="cpu")
    scale = np.asarray(load_slim_meta(str(DEFAULT_ZOO / "vocoder.npz"))
                       ["mel_scale_mean"], np.float32)[None]
    np.testing.assert_array_equal(scale[0], meta["mel_scale_mean"])
    rng = np.random.default_rng(0)
    T = 24
    text = rng.standard_normal((1, T, 256)).astype(np.float32)
    pros = rng.standard_normal((1, T, 18)).astype(np.float32)
    emo = rng.dirichlet(np.ones(6))[None].astype(np.float32)
    spk = (0.5 * rng.standard_normal((1, 16))).astype(np.float32)
    sid = np.array([3], np.int32)
    ref = jax.jit(jpipe.synthesize)(params, text, pros, emo, spk, sid,
                                    scale=scale)
    got = pipe.synthesize(*(torch.as_tensor(a) for a in
                            (text, pros, emo, spk, sid.astype(np.int64))),
                          scale=torch.as_tensor(scale))
    np.testing.assert_allclose(got.mel0.numpy(), np.asarray(ref.mel0),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.mel_ref.numpy(), np.asarray(ref.mel_ref),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.wav.numpy(), np.asarray(ref.wav),
                               rtol=0, atol=1e-4)
