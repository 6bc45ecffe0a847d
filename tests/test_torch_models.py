"""Model parity at a tiny configuration: ``ttsx_torch.models`` against
``ttsx.models`` on the same numpy inputs and the same weights, and
``TTSPipeline.synthesize`` end to end. The end-to-end test starts from
the reference's own ``init_params`` (perturbed so zero-initialised
layers carry signal); the per-model tests fill the reference's init tree
structure with seeded random values (``init_like``), which skips a
multi-second XLA compile of each ``init``.

The generator runs with both kernel flags on: the reference goes through
its Pallas kernels in interpret mode, the port (on the CPU) through the
kernels' plain versions. Configs cross between the packages by
``to_dict``/``from_dict``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_parity_helpers import close, init_like, perturb, port, randn, t

from ttsx_torch.core import config as tc

# torch on one thread: six workers share the cores (torch_parity_helpers)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tiny_cfg() -> tc.TTSXConfig:
    return tc.TTSXConfig(
        acoustic=tc.AcousticConfig(
            text_emb_dim=12, speaker_dim=4, hidden_channels=16,
            conformer_layers=1, attention_heads=2, transformer_dim=24,
            num_layers=2),
        refiner=tc.RefinerConfig(
            levels=1, cond_dim=16, beta_hidden=8, hsf_hidden=16, hsf_layers=3,
            hsf_kernel=3, style_dim=8, num_styles=5, vq_dims=(80, 80),
            vq_codes=(16, 16),
            s4=tc.S4Config(heads=2, l_max=16, causal=True, norm_groups=4)),
        vocoder=tc.VocoderConfig(
            hidden_dim=64, cond_dim=16, style_dim=8, upsample_factors=(4, 4, 2, 2),
            num_style_tokens=4, scale_cond=True, use_pallas_upsample=True,
            use_pallas_resblock_stack=True))


def _jax_cfg(cfg):
    from ttsx.core import config as jc
    return jc.from_dict(jc.TTSXConfig, tc.to_dict(cfg))


def test_config_round_trips_through_reference():
    from ttsx.core import config as jc
    cfg = tc.zoo_cfg()
    jcfg = _jax_cfg(cfg)
    assert jcfg.vocoder.use_pallas_resblock_stack and jcfg.vocoder.scale_cond
    assert tc.from_dict(tc.TTSXConfig, jc.to_dict(jcfg)) == cfg
    from ttsx.eval.parity import _tts_cfg
    ref = _tts_cfg()
    assert tc.to_dict(tc.tts_cfg().refiner) == jc.to_dict(ref.refiner)
    assert tc.to_dict(tc.tts_cfg().acoustic) == jc.to_dict(ref.acoustic)


def _inputs(T, cfg, B=2, seed=0):
    ac = cfg.acoustic
    return dict(text=randn(seed, B, T, ac.text_emb_dim),
                pros=randn(seed + 1, B, T, ac.cond_dim),
                emo=np.full((B, ac.emotion_dim), 1 / ac.emotion_dim, np.float32),
                spk=randn(seed + 2, B, ac.speaker_dim),
                sid=np.arange(B, dtype=np.int32) % cfg.refiner.num_styles,
                scale=randn(seed + 3, B, 2 * cfg.vocoder.channels))


def test_acoustic_parity():
    """T=11 (odd) exercises the stride-2 U-Net round trip."""
    from ttsx.models.acoustic import AcousticModel as JAcoustic
    from ttsx_torch.models.acoustic import AcousticModel
    cfg = _tiny_cfg()
    x = _inputs(11, cfg)
    jm = JAcoustic(_jax_cfg(cfg).acoustic)
    v = init_like(jm, x["text"], x["pros"], x["emo"], speaker=x["spk"])
    ref = jax.jit(jm.apply)(v, x["text"], x["pros"], x["emo"],
                            speaker=x["spk"])
    got = port(AcousticModel(cfg.acoustic), v)(
        t(x["text"]), t(x["pros"]), t(x["emo"]), speaker=t(x["spk"]))
    for name in ("mel", "duration", "pitch", "energy"):
        close(getattr(got, name), getattr(ref, name), 1e-4, 1e-5)


def test_refiner_parity():
    from ttsx.models.refiner import ScoreSDERefiner as JRefiner
    from ttsx_torch.models.refiner import ScoreSDERefiner
    cfg = _tiny_cfg()
    x = _inputs(12, cfg)
    mel0 = randn(9, 2, 12, 80)
    jm = JRefiner(_jax_cfg(cfg).refiner)
    v = init_like(jm, mel0, x["pros"], x["sid"], x["text"], seed=1)
    ref = jax.jit(jm.apply)(v, mel0, x["pros"], x["sid"], x["text"])
    got = port(ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim), v)(
        t(mel0), t(x["pros"]), t(x["sid"]).long(), t(x["text"]))
    close(got.mel_ref, ref.mel_ref, 1e-4, 1e-4)
    close(got.score, ref.score, 1e-4, 1e-4)
    close(got.mel_vq, ref.mel_vq, 1e-4, 1e-4)


@pytest.mark.parametrize("T", [6, 9])
def test_generator_kernel_flags_parity(T):
    """Both flags on: Pallas kernels (interpret) vs the port's kernel
    wrappers; the port's flags-off path gives the same waveform."""
    from ttsx.models.vocoder import Generator as JGenerator
    from ttsx_torch.models.vocoder import Generator
    cfg = _tiny_cfg()
    vc = cfg.vocoder
    x = _inputs(T, cfg)
    mel, style = randn(3, 2, T, 80), randn(4, 2, vc.style_dim)
    args = (mel, x["pros"], style, x["emo"])
    jm = JGenerator(_jax_cfg(cfg).vocoder)
    v = init_like(jm, *args, seed=2)
    ref = jax.jit(jm.apply)(v, *args, scale=x["scale"])
    gen = port(Generator(vc), v)
    got = gen(*map(t, args), scale=t(x["scale"]))
    assert got.shape == (2, T * 64, 1)
    close(got, ref, 1e-4, 1e-5)
    plain = Generator(dataclasses.replace(vc, use_pallas_upsample=False,
                                          use_pallas_resblock_stack=False))
    plain.load_state_dict(gen.state_dict())
    close(plain(*map(t, args), scale=t(x["scale"])), ref, 1e-4, 1e-5)


def test_pipeline_synthesize_end_to_end():
    """Text -> waveform through all four stages, both kernel flags on.
    Stated tolerance: wav within 1e-4 absolute (tanh output in [-1, 1])."""
    from ttsx.models.pipeline import TTSPipeline as JPipeline
    from ttsx_torch.models.pipeline import TTSPipeline
    cfg = _tiny_cfg()
    T = 12
    x = _inputs(T, cfg)
    jp = JPipeline(_jax_cfg(cfg))
    params = jp.init_params(jax.random.PRNGKey(3), batch=2, frames=T)
    params = {k: perturb(v, seed=i, scale=0.05)
              for i, (k, v) in enumerate(params.items())}
    ref = jax.jit(jp.synthesize)(params, x["text"], x["pros"], x["emo"],
                                 x["spk"], x["sid"], scale=x["scale"])
    pipe = TTSPipeline(cfg)
    for k in ("acoustic", "refiner", "gst", "generator"):
        port(getattr(pipe, k), params[k])
    got = pipe.synthesize(t(x["text"]), t(x["pros"]), t(x["emo"]),
                          t(x["spk"]), t(x["sid"]).long(),
                          scale=t(x["scale"]))
    assert got.wav.shape == (2, T * 64, 1)
    assert float(np.abs(np.asarray(ref.wav)).max()) > 1e-3
    close(got.wav, ref.wav, 0, 1e-4)
    close(got.mel0, ref.mel0, 1e-4, 1e-5)
    close(got.mel_ref, ref.mel_ref, 1e-4, 1e-4)
    close(got.duration, ref.duration, 1e-4, 1e-5)
    close(got.pitch, ref.pitch, 1e-4, 1e-5)
    plain = pipe.with_vocoder_kernels(False)
    assert plain.acoustic is pipe.acoustic
    assert not plain.cfg.vocoder.use_pallas_upsample
