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


def _ref_zoo():
    """(the reference's zoo pipeline, its parameters, the scale
    conditioning)."""
    from ttsx.train.slim_export import load_slim_meta
    from ttsx.zoo import DEFAULT_ZOO, load_pipeline as j_load
    jpipe, params = j_load()
    params.pop("_missing")
    scale = np.asarray(load_slim_meta(str(DEFAULT_ZOO / "vocoder.npz"))
                       ["mel_scale_mean"], np.float32)[None]
    return jpipe, params, scale


def _port_zoo(mode="auto"):
    """The port's zoo pipeline on the CPU, the refiner's S4 layers in
    ``mode``."""
    import dataclasses
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.zoo import load_pipeline, zoo_info
    cfg = zoo_cfg(True, zoo_info().get("vocoder_overrides"))
    s4 = dataclasses.replace(cfg.refiner.s4, kernel_mode=mode)
    cfg = dataclasses.replace(cfg, refiner=dataclasses.replace(cfg.refiner,
                                                               s4=s4))
    return load_pipeline(cfg, device="cpu")[0]


def _zoo_request(T: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, T, 256)).astype(np.float32),
            rng.standard_normal((1, T, 18)).astype(np.float32),
            rng.dirichlet(np.ones(6))[None].astype(np.float32),
            (0.5 * rng.standard_normal((1, 16))).astype(np.float32),
            np.array([3], np.int32))


def _port_args(x):
    return [torch.as_tensor(a) for a in x[:4]] + [
        torch.as_tensor(x[4].astype(np.int64))]


def _max_abs(got, ref) -> float:
    return float(np.abs(got.numpy() - np.asarray(ref)).max())


# max |port - reference| at the zoo on the CPU, single pass: at T = 864
# mel0 6.03e-5, mel_ref 5.75e-5, wav 5.87e-7; at 1,100 mel0 3.90e-5,
# mel_ref 3.70e-5, wav 7.65e-7 (the S4 FFT convolutions of two packages
# round differently); the tolerances are about 3x and 6x those
ZOO_LONG_WAV_TOL = 5e-6
ZOO_LONG_MEL_TOL = 2e-4


@pytest.mark.parametrize("frames", [864, 1100])
def test_zoo_single_pass_at_served_lengths_matches_reference(frames):
    """One 10 s request (T = 864) and one past the refiner's S4 ``l_max``
    of 1024 (T = 1,100, where the S4 kernel is tail-extended) through
    the zoo in f32, single pass: mel0, mel_ref and the waveform against
    the reference within ``ZOO_LONG_*_TOL``."""
    jpipe, params, scale = _ref_zoo()
    pipe = _port_zoo()
    x = _zoo_request(frames)
    ref = jax.jit(jpipe.synthesize)(params, *x, scale=scale)
    with torch.no_grad():
        got = pipe.synthesize(*_port_args(x), scale=torch.as_tensor(scale))
    errs = {k: _max_abs(getattr(got, k), getattr(ref, k))
            for k in ("mel0", "mel_ref", "wav")}
    print(json.dumps({"frames": frames, "max_abs_err": errs}))
    assert float(np.abs(np.asarray(ref.wav)).max()) > 1e-3
    assert errs["mel0"] <= ZOO_LONG_MEL_TOL and errs["mel_ref"] <= (
        ZOO_LONG_MEL_TOL)
    assert errs["wav"] <= ZOO_LONG_WAV_TOL


# measured (the reference's key-7 draws in both packages, T = 864, 8
# passes): mel_ref 3.76e-5 and wav 7.23e-7 on the fft route, 3.77e-5 and
# 7.25e-7 on the recurrence; the single pass's tolerances hold them
ZOO_SDE_MEL_TOL = ZOO_LONG_MEL_TOL
ZOO_SDE_WAV_TOL = ZOO_LONG_WAV_TOL


def test_zoo_sde_at_864_frames_matches_reference():
    """SDE synthesis of a 10 s request (8 refiner passes) through the
    zoo: the reference with ``rng = PRNGKey(7)``, the port given that
    key's draws as ``noise``, its refiner's S4 layers on the fft route
    and on the recurrence (K4's plain version on the CPU); mel_ref and
    the waveform within ``ZOO_SDE_*_TOL`` of the reference on both."""
    jpipe, params, scale = _ref_zoo()
    x = _zoo_request(864, seed=1)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p, *a: jpipe.synthesize(
        p, *a, rng=key, use_sde=True, scale=scale))(params, *x)
    steps = jpipe.cfg.refiner.sde_steps
    noise = [torch.tensor(np.asarray(jax.random.normal(k, (1, 864, 80))))
             for k in jax.random.split(key, steps)]
    errs = {}
    for route, mode in (("fft", "fft"), ("recurrence", "pallas")):
        pipe = _port_zoo(mode)
        with torch.no_grad():
            got = pipe.synthesize(*_port_args(x), use_sde=True, noise=noise,
                                  scale=torch.as_tensor(scale))
        errs[route] = {k: _max_abs(getattr(got, k), getattr(ref, k))
                       for k in ("mel_ref", "wav")}
    print(json.dumps({"frames": 864, "passes": steps, "max_abs_err": errs}))
    for e in errs.values():
        assert e["mel_ref"] <= ZOO_SDE_MEL_TOL and e["wav"] <= ZOO_SDE_WAV_TOL


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


# ------------------------------------ the observer's prosody stage, the zoo
def _speaker_wav(frames: int) -> np.ndarray:
    """A held-out voice of the zoo's corpus, its utterances joined, cut
    to ``frames`` hops of 256 samples at 22,050 Hz (1,100 frames: past
    the S4 ``l_max``; 4,096: the stage's whole window)."""
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.zoo import AUDIO
    corpus = ToneCorpus(n_speakers=8, audio=AUDIO)
    n = frames * 256
    parts, got = [], 0
    for i in range(64):
        u = corpus.utterances(1, 400, seed=50 + i, speakers=[3])[0]
        parts += [u.wav, np.zeros(2000, np.float32)]
        got += len(u.wav) + 2000
        if got >= n:
            break
    return np.concatenate(parts)[:n].astype(np.float32)


def _prosody_trend(stage, wav, root):
    from ttsx_torch.data.dataset import write_wav
    (root / "speakers").mkdir(parents=True)
    write_wav(root / "speakers" / "spk.wav", wav, 22050)
    out = stage({"output_dir": str(root), "speaker_ids": ["spk"]})
    assert out["status"] == "ok", out
    return json.loads((root / "emotion_tags/spk/prosody_trend.json")
                      .read_text())


@pytest.mark.parametrize("frames", [1100, 4096])
def test_zoo_prosody_stage_matches_reference(frames, tmp_path):
    """``ProsodyExtractStage`` with the zoo's predictor in both packages
    (the reference's stage given the zoo's config and tree, the port's
    the ``ProsodyPredictor`` of ``load_prosody``) on a speaker wav of
    ``frames`` frames: f0 and energy within one rounding step (0.01,
    1e-5), voicing equal, the predictor's f0 and MFCC within one rounding
    step (0.01, 1e-3) plus 1e-4 of their largest magnitude, its
    utterance scalars within 1e-4 of theirs (stage 2's tolerance,
    ``test_zoo_refenc_and_prosody_match_reference``)."""
    from ttsx import zoo as jzoo
    from ttsx.pipeline.asr import ProsodyExtractStage as RStage
    from ttsx_torch.pipeline.asr import ProsodyExtractStage
    from ttsx_torch.zoo import load_prosody
    wav = _speaker_wav(frames)
    jt, jp = jzoo.load_prosody()
    want = _prosody_trend(RStage(jt.cfg, jp), wav, tmp_path / "ref")
    got = _prosody_trend(ProsodyExtractStage(
        params=load_prosody(device="cpu")[1], device="cpu"), wav,
        tmp_path / "port")
    assert got.keys() == want.keys()
    assert len(got["model_f0"]) == min(frames + 1, 4096)   # centred frames
    errs = {}
    # (rounding step, relative part): f0 and energy as the CPU parity test
    # of the observer (tests/test_torch_observer.py::TREND_TOL)
    for k, step, rel in (("f0", 0.01, 0), ("energy", 1e-5, 0),
                         ("voiced_ratio", 0, 0), ("model_f0", 0.01, 1e-4),
                         ("mfcc", 1e-3, 1e-4), ("speech_rate", 0, 1e-4),
                         ("pause_dur", 0, 1e-4)):
        g, w = np.asarray(got[k], float), np.asarray(want[k], float)
        errs[k] = float(np.abs(g - w).max())
        tol = step + rel * float(np.abs(w).max())
        assert errs[k] <= tol + 1e-9, (k, errs[k], tol)
    print(json.dumps({"frames": frames, "max_abs_diff": errs}))


def test_reference_observer_runs_the_zoo_predictor_in_the_wrong_config(
        tmp_path):
    """Departure: the reference's ``ObserverPipeline(prosody_params=...)``
    hands its prosody stage the weights alone, and the stage builds
    ``ProsodyConfig()`` (8 norm groups, the normalized mel) where the
    zoo's predictor has 4 and the unnormalized mel. The tree loads
    without an error and the model's outputs are far from the zoo
    predictor's; the port's pipeline, given the ``ProsodyPredictor`` of
    ``load_prosody`` (or its config as ``prosody_cfg``), runs the
    predictor as trained."""
    from ttsx import zoo as jzoo
    from ttsx.pipeline import ObserverPipeline as RPipeline
    from ttsx.pipeline.asr import ProsodyExtractStage as RStage
    from ttsx_torch.pipeline import ObserverPipeline
    from ttsx_torch.zoo import load_prosody
    wav = _speaker_wav(1100)
    jt, jp = jzoo.load_prosody()
    stage = RPipeline(prosody_params=jp).stages[0]
    assert stage.cfg.s4.norm_groups == 8 and stage.cfg.audio.mel_normalize
    wrong = _prosody_trend(stage, wav, tmp_path / "ref_pipeline")
    right = _prosody_trend(RStage(jt.cfg, jp), wav, tmp_path / "ref_zoo")
    port = _prosody_trend(ObserverPipeline(
        prosody_params=load_prosody(device="cpu")[1], device="cpu"
    ).stages[0], wav, tmp_path / "port")
    gap = {k: float(np.abs(np.asarray(wrong[k]) - np.asarray(right[k]))
                    .max()) for k in ("model_f0", "mfcc")}
    print(json.dumps({"reference_pipeline_vs_zoo_config": gap}))
    assert gap["model_f0"] > 0.1 and gap["mfcc"] > 0.1
    for k in ("model_f0", "mfcc"):
        np.testing.assert_allclose(port[k], right[k], rtol=0, atol=0.02)


def test_refenc_cli_chain_beside_reference(tmp_path, capsys):
    """The reference's ``refenc-train -> eer -> fuse`` console scripts
    and the port's on the same FormantCorpus list (4 steps, batch 2, 0.8
    s crops, EER every 2 steps): the same JSON keys, steps and speaker
    counts, an EER of every file on each side, and a written export (the
    reference's StableHLO, the port's ``.pt2``). The reference's eager
    encoder runs at full width: about a minute here."""
    from ttsx.cli.main import main_refenc_eer as jeer
    from ttsx.cli.main import main_refenc_fuse as jfuse
    from ttsx.cli.main import main_refenc_train as jtrain
    from ttsx_torch.cli.main import (main_refenc_eer, main_refenc_fuse,
                                     main_refenc_train)
    from test_torch_refenc_cli import formant_list
    lst = formant_list(tmp_path, 2, 3, 110)
    out = {}
    for name, (train, eer, fuse) in (("ref", (jtrain, jeer, jfuse)),
                                     ("port", (main_refenc_train,
                                               main_refenc_eer,
                                               main_refenc_fuse))):
        run = tmp_path / name
        args = ["--device", "cpu", "--output-dir", str(run)]
        got = []
        for main, argv in (
                (train, [str(lst), "--eval-list", str(lst), "--max-steps",
                         "4", "--batch", "2", "--crop-seconds", "0.8",
                         "--eval-every", "2", "--workers", "1"]),
                (eer, [str(lst), "--checkpoint", str(run / "checkpoints")]),
                (fuse, ["--checkpoint", str(run / "checkpoints"), "--out",
                        str(run / "encoder.export")])):
            assert main(argv + args) == 0
            got.append(json.loads(
                capsys.readouterr().out.strip().splitlines()[-1]))
        out[name] = got
    print(json.dumps(out))
    for ref, port in zip(out["ref"], out["port"]):
        assert set(ref) == set(port)
    (rt, re_, rf), (pt, pe, pf) = out["ref"], out["port"]
    assert rt["steps"] == pt["steps"] == 4
    assert rt["n_speakers"] == pt["n_speakers"] == 2
    assert re_["n"] == pe["n"] == 6
    assert 0.0 <= pe["eer"] <= 1.0 and 0.0 <= re_["eer"] <= 1.0
    assert rf["aot_compiled"] and pf["aot_compiled"]
    assert rf["bytes"] > 0 and pf["bytes"] > 0
