"""Full-width parity on the checked-in zoo: the trained model through
``ttsx`` (JAX on the CPU) and through ``ttsx_torch`` (CPU, both kernel
flags on, so the generator takes the kernels' plain versions).

Marked slow: the reference compiles the full-width chain on the CPU,
which takes minutes. Stated tolerance: waveform within 1e-4 absolute,
mels within 1e-3 absolute.

The bf16 case serves ``chip_smoke.py``'s three requests (864, 600 and
300 frames from seed 0) one at a time in a bucket of 864 frames through
the reference's f32 and bf16 servers, the reference's bf16 server
compiled with every op rounded to its dtype
(``xla_allow_excess_precision=False``), and the port's bf16 server. It
prints the reference's own |bf16 - f32| per request, the number
chip_smoke's phase 4c holds the card to (``BF16_REF_DIST``). The port is
held within ``ZOO_BF16_OP_TOL`` of the op-by-op reference, within
``ZOO_BF16_TOL`` of the reference's bf16 server as it runs (XLA's excess
precision skips some bf16 roundings there: measured 1.2e-4 to 3.0e-4
from the port, against bf16-to-f32 distances of 5.7e-4 to 6.5e-4), and
no farther from the reference's f32 waveform than 1.5 times the
reference's bf16 waveform is, plus 1e-6.
"""
import json

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


ZOO_BF16_OP_TOL = 1e-5
ZOO_BF16_TOL = 5e-4


def _op_by_op(srv):
    """The reference server's three stage programs compiled with every op
    rounded to its dtype (compiled once, at the bucket's shapes)."""
    def wrap(fn):
        cache = []

        def run(*args):
            if not cache:
                cache.append(jax.jit(fn).lower(*args).compile(
                    compiler_options={"xla_allow_excess_precision": False}))
            return cache[0](*args)
        return run
    for name in ("_ac_fn", "_rf_fn", "_gg_fn"):
        setattr(srv, name, wrap(getattr(srv, name)))
    return srv


def test_zoo_bf16_server_at_864_frames_matches_reference():
    import chip_smoke
    from ttsx.core import config as jc
    from ttsx.serve import SynthesisRequest as JRequest
    from ttsx.zoo import serve_from_zoo as j_serve
    from ttsx_torch.core import config as tc
    from ttsx_torch.zoo import serve_from_zoo
    srv = serve_from_zoo(device="cpu", max_batch=1, frames=864)
    assert srv.dtype == torch.bfloat16
    cfg = srv.cfg
    assert cfg.vocoder.use_pallas_upsample
    assert cfg.vocoder.use_pallas_resblock_stack
    reqs = chip_smoke.requests(cfg, 0)
    got = srv.serve_batch(reqs)
    jcfg = jc.from_dict(jc.TTSXConfig, tc.to_dict(cfg))
    jreqs = [JRequest(**vars(r)) for r in reqs]
    kw = dict(cfg=jcfg, max_batch=1, frames=864)
    ref = {bf: j_serve(bf16=bf, **kw).serve_batch(jreqs)
           for bf in (True, False)}
    op = _op_by_op(j_serve(bf16=True, **kw)).serve_batch(jreqs)
    dist = [float(np.abs(b - f).max()) for b, f in zip(ref[True], ref[False])]
    diff = lambda xs, ys: [float(np.abs(x - y).max()) for x, y in zip(xs, ys)]
    print(json.dumps({"requests": [len(r.text_emb) for r in reqs],
                      "reference_bf16_minus_f32_max_abs": dist,
                      "port_bf16_minus_reference_f32_max_abs":
                          diff(got, ref[False]),
                      "port_bf16_minus_reference_bf16_max_abs":
                          diff(got, ref[True]),
                      "port_bf16_minus_reference_bf16_op_by_op_max_abs":
                          diff(got, op)}))
    for g, b, o, f, d in zip(got, ref[True], op, ref[False], dist):
        assert g.shape == b.shape and g.dtype == np.float32
        assert d > 1e-6
        assert float(np.abs(g - f).max()) <= 1.5 * d + 1e-6
        np.testing.assert_allclose(g, o, rtol=0, atol=ZOO_BF16_OP_TOL)
        np.testing.assert_allclose(g, b, rtol=0, atol=ZOO_BF16_TOL)


# ------------------------------------------------ stages 1 and 2 of the zoo
def zoo_mels(frames: int, n: int = 4, seed: int = 5):
    """Held-out utterances of the zoo's training corpus as the exports'
    unnormalized log-mel [n, frames, 80], and their speakers."""
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.dsp.stft import mel_spectrogram
    from ttsx_torch.zoo import AUDIO
    corpus = ToneCorpus(n_speakers=8, audio=AUDIO)
    utts = corpus.utterances(1, frames, seed=seed, speakers=range(n))
    wav = torch.as_tensor(np.stack([u.wav for u in utts]))
    return (mel_spectrogram(wav, AUDIO)[:, :frames].numpy(),
            np.asarray([u.speaker for u in utts]))


@pytest.mark.parametrize("frames", [128, 864])
def test_zoo_refenc_and_prosody_match_reference(frames):
    """``load_refenc`` / ``load_prosody`` at full width against
    ``ttsx.zoo``'s on the corpus's mels: embeddings within 1e-5, each of
    the predictor's outputs within 1e-4 of its largest magnitude (the
    FFT convolutions of 864 + 1024 points round differently: 2.1e-5 of
    4.5 at most measured)."""
    from ttsx import zoo as jzoo
    from ttsx_torch.zoo import load_prosody, load_refenc
    mel, _ = zoo_mels(frames)
    jt, jp = jzoo.load_refenc()
    pt, enc = load_refenc(device="cpu")
    assert pt.cfg.loss == "arcface" and pt.cfg.num_speakers == 12
    ref = np.asarray(jt.embed(jp, jax.numpy.asarray(mel)))
    np.testing.assert_allclose(pt.embed(mel).numpy(), ref, rtol=0, atol=1e-5)
    jt, jp = jzoo.load_prosody()
    pt, pred = load_prosody(device="cpu")
    ref = jt.model.apply(jp, jax.numpy.asarray(mel))
    with torch.no_grad():
        got = pred(torch.as_tensor(mel))
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_ge2e_export_loads_in_the_port(tmp_path):
    """A GE2E-headed speaker export (the reference trainer's own tree)
    loads whole in the port, which reads the head from its leaves; the
    reference's ``load_refenc`` builds the ArcFace head of its config's
    default and cannot load it."""
    from ttsx import zoo as jzoo
    from ttsx.core.config import RefEncConfig
    from ttsx.eval.parity_common import AUDIO
    from ttsx.train.refenc_trainer import RefEncTrainer
    from ttsx.train.slim_export import load_slim, save_slim
    from ttsx_torch.zoo import load_refenc
    jt = RefEncTrainer(RefEncConfig(audio=AUDIO, loss="ge2e",
                                    num_speakers=5))
    mel, _ = zoo_mels(128)
    state = jt.init_state(jax.random.PRNGKey(3), jax.numpy.asarray(mel))
    path = str(tmp_path / "refenc.npz")
    save_slim(path, {"refenc": state.params,
                     "_meta": {"num_speakers": np.int64(5)}})
    pt, _ = load_refenc(str(tmp_path), device="cpu")
    assert pt.cfg.loss == "ge2e"
    assert float(pt.params.ge2e_w.detach()) == 10.0
    stored = load_slim(path, {"refenc": state.params})["refenc"]
    ref = np.asarray(jt.embed(stored, jax.numpy.asarray(mel)))
    np.testing.assert_allclose(pt.embed(mel).numpy(), ref, rtol=0, atol=1e-5)
    with pytest.raises(KeyError, match="arcface_w"):
        jzoo.load_refenc(str(tmp_path))
