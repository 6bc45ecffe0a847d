"""SDE-sampled synthesis against ``ttsx``, and ``main_synth``.

At tests/test_train.py's tiny config: ``sde_sample`` and
``TTSPipeline.synthesize(use_sde=True)`` of the port against the
reference on the same weights and the same noise. The reference draws
step k's noise as ``jax.random.normal(keys[k], ...)`` with ``keys =
jax.random.split(rng, steps)`` (``ttsx/models/refiner.py:sde_sample``);
the test makes those draws itself and hands them to the port as
``noise``. The refiner's S4 layers run in ``fft`` and in ``pallas`` mode
(the slice on the card: K4, here its plain version, against the
reference's associative scan on the CPU).

Tolerances: mel 1e-4 relative / 1e-4 absolute after 2 refiner passes
(each pass within 1e-4 in tests/test_torch_models.py); waveform 1e-4
absolute (tanh output), as the single-pass pipeline test.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_parity_helpers import close, init_like, port, randn, t
from torch_train_helpers import jax_cfg, tiny_cfg

from ttsx_torch.core import config as tc

# torch on one thread: six workers share the cores (torch_parity_helpers)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(mode: str) -> tc.TTSXConfig:
    """tests/test_train.py's tiny config (its vocoder too) without
    dropout, the refiner's S4 layers in ``mode``."""
    cfg = tiny_cfg(dropout=0.0)
    s4 = dataclasses.replace(cfg.refiner.s4, kernel_mode=mode)
    return dataclasses.replace(
        cfg, refiner=dataclasses.replace(cfg.refiner, s4=s4),
        vocoder=tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16))


def _draws(rng, steps, shape):
    """The reference's per-step noise, as ``sde_sample`` draws it."""
    return [torch.tensor(np.asarray(jax.random.normal(k, shape)))
            for k in jax.random.split(rng, steps)]


@pytest.mark.parametrize("mode", ["fft", "pallas"])
def test_sde_sample_matches_reference(mode):
    from ttsx.models.refiner import ScoreSDERefiner as JRefiner
    from ttsx.models.refiner import sde_sample as jsde
    from ttsx_torch.models.refiner import ScoreSDERefiner, sde_sample
    cfg = _cfg(mode)
    B, T = 2, 12
    mel0, pros = randn(0, B, T, 80), randn(1, B, T, 18)
    text = randn(2, B, T, cfg.acoustic.text_emb_dim)
    sid = np.array([1, 3], np.int32)
    jm = JRefiner(jax_cfg(cfg).refiner)
    v = init_like(jm, mel0, pros, sid, text, seed=3)
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, *a: jsde(jm, p, *a, rng))(v, mel0, pros, sid,
                                                       text)
    m = port(ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim), v)
    noise = _draws(rng, cfg.refiner.sde_steps, (B, T, 80))
    with torch.no_grad():
        got = sde_sample(m, t(mel0), t(pros), t(sid).long(), t(text),
                         noise=noise)
        single = m(t(mel0), t(pros), t(sid).long(), t(text)).mel_ref
    close(got, ref, **MEL_TOL)
    assert float((got - single).abs().max()) > 1e-3   # the SDE moved it
    with pytest.raises(ValueError, match="noise tensors"):
        sde_sample(m, t(mel0), t(pros), t(sid).long(), t(text),
                   noise=noise[:1])


def test_synthesize_use_sde_matches_reference():
    """Text -> waveform with the SDE sampler, the refiner's S4 layers on
    the recurrent route (``pallas``) in both packages."""
    from ttsx.models.pipeline import TTSPipeline as JPipeline
    from ttsx_torch.models.pipeline import TTSPipeline
    cfg = _cfg("pallas")
    B, T = 2, 10
    ac = cfg.acoustic
    x = dict(text=randn(0, B, T, ac.text_emb_dim), pros=randn(1, B, T, 18),
             emo=np.full((B, 6), 1 / 6, np.float32),
             spk=randn(2, B, ac.speaker_dim),
             sid=np.array([0, 2], np.int32))
    jp = JPipeline(jax_cfg(cfg))
    mel = randn(3, B, T, 80)
    style = randn(4, B, cfg.vocoder.style_dim)
    params = {
        "acoustic": init_like(jp.acoustic, x["text"], x["pros"], x["emo"],
                              speaker=x["spk"], seed=1),
        "refiner": init_like(jp.refiner, mel, x["pros"], x["sid"],
                             x["text"], seed=2),
        "gst": init_like(jp.gst, mel, seed=3),
        "generator": init_like(jp.generator, mel, x["pros"], style,
                               x["emo"], seed=4)}
    rng = jax.random.PRNGKey(11)
    ref = jax.jit(lambda p, *a: jp.synthesize(p, *a, rng=rng, use_sde=True))(
        params, x["text"], x["pros"], x["emo"], x["spk"], x["sid"])
    pipe = TTSPipeline(cfg)
    for k in ("acoustic", "refiner", "gst", "generator"):
        port(getattr(pipe, k), params[k])
    noise = _draws(rng, cfg.refiner.sde_steps, (B, T, 80))
    got = pipe.synthesize(t(x["text"]), t(x["pros"]), t(x["emo"]),
                          t(x["spk"]), t(x["sid"]).long(), use_sde=True,
                          noise=noise)
    assert got.wav.shape == (B, T * cfg.vocoder.hop_length, 1)
    assert float(np.abs(np.asarray(ref.wav)).max()) > 1e-3
    close(got.mel_ref, ref.mel_ref, **MEL_TOL)
    close(got.wav, ref.wav, 0, 1e-4)


def test_main_synth_sde_on_the_cpu(tmp_path, capsys):
    """``main_synth --zoo --sde --device cpu`` on a short request: one wav
    of frames * hop samples, the reference's JSON line, and the waveform
    ``synthesize(use_sde=True)`` of the zoo pipeline gives on the same
    seed."""
    from ttsx_torch.cli.main import main_synth
    from ttsx_torch.data.dataset import TextEncoder, read_wav
    from ttsx_torch.zoo import load_pipeline
    pipe, _ = load_pipeline(device="cpu")
    cfg = pipe.cfg
    out = tmp_path / "x.wav"
    frames, hop = 12, cfg.vocoder.hop_length
    argv = ["--zoo", "--sde", "--device", "cpu", "--frames", str(frames),
            "--out", str(out), "--seed", "4", "--text", "a b"]
    assert main_synth(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"wav": str(out), "samples": frames * hop,
                    "seconds": frames * hop / cfg.vocoder.sr}
    wav, sr = read_wav(out)
    assert sr == cfg.vocoder.sr and wav.shape == (frames * hop,)
    emb = torch.as_tensor(TextEncoder(cfg.acoustic.text_emb_dim)("a b"))
    ac = cfg.acoustic
    want = pipe.synthesize(
        emb.expand(1, frames, -1), torch.zeros(1, frames, ac.cond_dim),
        torch.full((1, 6), 1 / 6), torch.zeros(1, ac.speaker_dim),
        torch.zeros(1, dtype=torch.long), use_sde=True,
        generator=torch.Generator().manual_seed(4)).wav[0, :, 0].numpy()
    assert float(np.abs(want).max()) > 1e-3
    # 16-bit PCM on disk
    np.testing.assert_allclose(wav, np.clip(want, -1, 1), atol=1 / 16384)
    # a directory without a 'best' checkpoint is refused
    with pytest.raises(FileNotFoundError, match="best"):
        main_synth(argv + ["--checkpoint", str(tmp_path)])
