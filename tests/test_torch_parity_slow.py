"""Whole parity experiments of the port against ``ttsx`` on the CPU, at
``_tts_cfg()``'s full width and toy sizes (a few steps, 16-32 frames,
small batches).

Both packages start from the same weights and run on the same draws:
the reference's blocks and trainers are replaced by subclasses whose
``init_state`` takes ``init_like`` trees (no init compile) and keeps
them; the port's by subclasses that load those trees. Inside the
reference's run ``jax.random``'s samplers are replaced by numpy draws
(``JaxDraws``); a jitted step bakes its trace's draws in, so every
reference step runs on the draws of its one trace, and the port's block
replays those draws at every step (``CyclicReplay``).

Tolerances (and what was found): the reference's keys everywhere; step
counts and eval sizes equal; the acoustic MCDs and loss within 1e-5
relative (1.4e-7); the refenc EERs within one pair's share of the
all-pairs count (equal), its loss within 1e-4 relative (3.2e-7);
prosody losses and Pearson r within 1e-4 relative + 1e-5 (losses
2.1e-6 relative, r 7.5e-6 absolute); the GAN's loss tails within 1e-3
relative + 1e-6 (the f32 gradient of the generator loss is accurate to
about 1e-3, ``tests/test_torch_gan.py``; found 1.6e-4 on the G tail's
std, 1.3e-5 on its mean), its discriminators' count exactly. ``e2e_parity(zoo_dir=)`` runs in the
port alone: its npz keys and shapes equal the checked-in zoo's, and the
exported zoo serves. ``record_baseline``'s record has the reference's
keys.

Marked slow: the reference compiles full-width steps on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import init_like, to_numpy
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_train_helpers import JaxDraws, seed_block_init

from ttsx_torch.nn.draws import ReplayDraws
from ttsx_torch.weights import from_flax, from_flax_params, load_flax

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_torch_thread")]


class CyclicReplay(ReplayDraws):
    """The recorded draws again from the first once they run out."""

    def _next(self, kind, shape):
        if self.pos == len(self.records):
            self.pos = 0
        return super()._next(kind, shape)


def _close(got, ref, rtol, atol=0.0, skip=()):
    """``got`` and ``ref`` have the same keys (nested), equal strings,
    bools and ints, floats within rtol / atol."""
    assert isinstance(got, dict) and got.keys() == ref.keys(), (
        sorted(got), sorted(ref))
    for k, r in ref.items():
        g = got[k]
        if k in skip:
            continue
        if isinstance(r, dict):
            _close(g, r, rtol, atol, skip)
        elif isinstance(r, list):
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(r, float), rtol=rtol,
                                       atol=atol, err_msg=k)
        elif isinstance(r, float) and not isinstance(g, bool):
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            assert g == r, k


TIMES = ("train_seconds",)


def reference_features(monkeypatch, module):
    """The corpora of ``ttsx_torch.eval.<module>`` take their features
    from the reference's corpus of the same arguments: the two packages'
    corpus mels agree within 1e-4 absolute
    (``tests/test_torch_refenc.py::test_tone_corpus_matches_reference``),
    and an MCD of raw log-mels carries that as about 1e-4 relative, which
    would hide the training's own agreement."""
    import dataclasses
    import importlib
    from ttsx.core.config import AudioConfig
    from ttsx.eval.parity_common import make_corpus as jmake
    from ttsx_torch.eval.parity_common import make_corpus as pmake

    def make(kind="tone", **kw):
        pc = pmake(kind, **kw)
        jkw = dict(kw, audio=AudioConfig(**dataclasses.asdict(kw["audio"])))
        ref = jmake(kind, **jkw)
        pc.features = lambda utts, device: ref.features(utts)
        return pc
    monkeypatch.setattr(importlib.import_module(f"ttsx_torch.eval.{module}"),
                        "make_corpus", make)


def test_acoustic_parity_matches_reference(monkeypatch):
    from ttsx.eval.parity import acoustic_parity as jrun
    from ttsx.train import blocks as J
    from ttsx_torch.eval.parity import acoustic_parity
    from ttsx_torch.train import blocks as P
    kept = {}

    class JA(J.AcousticBlock):
        def init_state(self, rng, batch):
            kept["tree"] = seed_block_init(
                "acoustic", self, {k: np.asarray(v) for k, v in batch.items()},
                0)
            return super().init_state(rng, batch)

    class PA(P.AcousticBlock):
        def __init__(self, cfg, device="cuda", seed=0):
            super().__init__(cfg, device, seed)
            load_flax(self.model, kept["tree"])
            self.state.draws = CyclicReplay(kept["draws"])

    kw = dict(n_speakers=2, utts_train=2, utts_eval=1, frames=16, steps=3,
              batch=2)
    monkeypatch.setattr(J, "AcousticBlock", JA)
    with monkeypatch.context() as m:
        draws = JaxDraws(m)
        ref = jrun(**kw)
    kept["draws"] = draws.records
    assert kept["draws"]
    monkeypatch.setattr(P, "AcousticBlock", PA)
    reference_features(monkeypatch, "parity")
    got = acoustic_parity(**kw, device="cpu")
    _close(got, ref, 1e-5, skip=TIMES)
    assert got["mcd_db"] != got["mcd_random_weights_db"]


def test_refenc_parity_matches_reference(monkeypatch):
    """ArcFace with mixup, fresh crops, two eval crops and the best-EER
    curve; the EERs within one pair's share of the pairs."""
    from ttsx.eval.parity_refenc import refenc_parity as jrun
    from ttsx.train import refenc_trainer as J
    from ttsx_torch.eval.parity_refenc import refenc_parity
    from ttsx_torch.train import refenc_trainer as P
    kept = {}

    class JT(J.RefEncTrainer):
        def init_state(self, rng, mel):
            tree = init_like(self.model, jnp.asarray(mel), seed=1,
                             scale=0.2)
            object.__setattr__(self.model, "init", lambda *a, **k: tree)
            st = super().init_state(rng, mel)
            kept["params"] = to_numpy(st.params)
            return st

    class PT(P.RefEncTrainer):
        def __init__(self, cfg, device="cuda", seed=0):
            super().__init__(cfg, device, seed)
            self.params.load_state_dict(from_flax_params(self.params,
                                                         kept["params"]))

    kw = dict(n_speakers=4, utts_train=2, utts_eval=2, frames=32, steps=3,
              batch=8, eval_every=1, mixup=True, train_frames=40,
              eval_crops=2)
    monkeypatch.setattr(J, "RefEncTrainer", JT)
    ref = jrun(**kw)
    monkeypatch.setattr(P, "RefEncTrainer", PT)
    got = refenc_parity(**kw, device="cpu")
    n = ref["eval_utts"]
    pair = 2.0 / (n * (n - 1))
    eers = ("eer", "eer_random_weights", "eer_final")
    _close(got, ref, 1e-4, skip=TIMES + eers + ("eer_curve",))
    for k in eers:
        assert abs(got[k] - ref[k]) <= pair + 1e-9, k
    np.testing.assert_allclose(got["eer_curve"], ref["eer_curve"],
                               atol=pair + 1e-4)


def test_prosody_parity_matches_reference(monkeypatch):
    from ttsx.eval.parity_prosody import prosody_parity as jrun
    from ttsx.train import prosody_trainer as J
    from ttsx_torch.eval.parity_prosody import prosody_parity
    from ttsx_torch.train import prosody_trainer as P
    kept = {}

    class JT(J.ProsodyTrainer):
        def init_state(self, rng, mel):
            tree = init_like(self.model, jnp.asarray(mel), seed=2, scale=0.2)
            object.__setattr__(self.model, "init", lambda *a, **k: tree)
            st = super().init_state(rng, mel)
            kept["params"] = to_numpy(st.params)
            return st

    class PT(P.ProsodyTrainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            load_flax(self.model, kept["params"])

    kw = dict(steps=3, frames=32, batch=2, n_speakers=2, utts_train=2,
              utts_eval=2, cond_dim=32, n_layers=1)
    monkeypatch.setattr(J, "ProsodyTrainer", JT)
    ref = jrun(**kw)
    monkeypatch.setattr(P, "ProsodyTrainer", PT)
    got = prosody_parity(**kw, device="cpu")
    assert len(got["eval_curve"]) == len(ref["eval_curve"])
    for g, r in zip(got.pop("eval_curve"), ref.pop("eval_curve")):
        _close(g, r, 1e-4, 1e-5)
    _close(got, ref, 1e-4, 1e-5, skip=TIMES)


def _vocoder_trees(jb, batch):
    """``init_like`` trees of the reference block's six parts (the
    discriminators at scale 0.3, as ``tests/test_torch_gan.py`` draws
    them; the generator at 0.05: at its tiny config's 0.15 the full-width
    generator's pre-tanh activations reach 4e7 and the reference's GAN
    step is NaN from the first step); its ``init_state`` then returns
    them."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    style = jnp.zeros((b["mel"].shape[0], jb.cfg.vocoder.style_dim))
    mods = {"gen": (jb.gen, (b["mel"], b["prosody"], style,
                             b["emotion_probs"]), 0.05),
            "gst": (jb.gst, (b["mel"],), 0.05),
            "mpd": (jb.mpd, (b["wav"],), 0.3),
            "msd": (jb.msd, (b["wav"],), 0.3),
            "mbd": (jb.mbd, (b["wav"],), 0.3),
            "stft": (jb.stft_loss, (b["wav"], b["wav"]), 0.05)}
    trees = {}
    for i, (name, (mod, args, scale)) in enumerate(mods.items()):
        trees[name] = to_numpy(init_like(mod, *args, seed=i, scale=scale))
        object.__setattr__(mod, "init", lambda *a, t=trees[name], **k: t)
    return trees


def test_vocoder_gan_smoke_matches_reference(monkeypatch):
    from ttsx.eval.parity_aux import vocoder_gan_smoke as jrun
    from ttsx.train import blocks as J
    from ttsx_torch.eval.parity_aux import vocoder_gan_smoke
    from ttsx_torch.train import blocks as P
    kept = {}

    class JV(J.VocoderBlock):
        def init_state(self, rng, batch):
            kept["trees"] = _vocoder_trees(self, batch)
            return super().init_state(rng, batch)

    class PV(P.VocoderBlock):
        def __init__(self, cfg, device="cuda", seed=0):
            super().__init__(cfg, device, seed)
            for name in self.PARTS:
                load_flax(getattr(self, name), kept["trees"][name])
            load_flax(self.stft, kept["trees"]["stft"])
            self.states["gen"].reset_ema()
            self.states["gen"].draws = CyclicReplay(kept["draws"])

    kw = dict(steps=3, frames=32, batch=2, n_speakers=2)
    monkeypatch.setattr(J, "VocoderBlock", JV)
    with monkeypatch.context() as m:
        draws = JaxDraws(m)
        ref = jrun(**kw)
    kept["draws"] = draws.records
    monkeypatch.setattr(P, "VocoderBlock", PV)
    reference_features(monkeypatch, "parity_aux")
    got = vocoder_gan_smoke(**kw, device="cpu")
    _close(got, ref, 1e-3, 1e-6, skip=TIMES)
    assert got["disc_params"] == ref["disc_params"] == 28_631_892


def test_e2e_zoo_export_has_the_zoo_layout_and_serves(tmp_path):
    """The port's ``e2e_parity(zoo_dir=)`` at cut steps: every npz key and
    shape of the checked-in zoo's acoustic, refiner and vocoder exports,
    zoo.json's fields, finite readouts with the reference record's keys,
    and the exported zoo through ``serve_from_zoo``."""
    from ttsx_torch.eval.parity_e2e import e2e_parity
    from ttsx_torch.zoo import DEFAULT_ZOO, serve_from_zoo
    zd = tmp_path / "zoo"
    ov = {"scale_cond": True, "lambda_energy": 1.0}
    got = e2e_parity(acoustic_steps=1, refiner_steps=1, vocoder_steps=1,
                     frames=16, batch=2, zoo_dir=str(zd),
                     vocoder_overrides=ov, device="cpu")
    for name in ("acoustic", "refiner", "vocoder"):
        with np.load(zd / f"{name}.npz") as a, \
                np.load(DEFAULT_ZOO / f"{name}.npz") as b:
            assert {k: a[k].shape for k in a.files} == {
                k: b[k].shape for k in b.files}, name
    z, zref = (json.loads((d / "zoo.json").read_text())
               for d in (zd, DEFAULT_ZOO))
    assert z.keys() == zref.keys() and z["vocoder_overrides"] == ov
    assert z["steps"] == {"acoustic": 1, "refiner": 1, "vocoder": 1}
    ref = json.loads((DEFAULT_ZOO.parent / "parity.json").read_text())["e2e"]
    assert set(ref) <= set(got) == {
        "exp", "acoustic_mcd_db", "corpus", "copy_synthesis", "text_to_wav",
        "text_to_wav_ema", "text_to_wav_sde_ema", "eval_utts", "steps",
        "vocoder"}
    for k in ("copy_synthesis", "text_to_wav", "text_to_wav_ema",
              "text_to_wav_sde_ema"):
        assert set(ref.get(k, ref["text_to_wav"])) <= set(got[k]), k
        assert all(np.isfinite(v) for v in got[k].values()), k
    srv = serve_from_zoo(str(zd), device="cpu", bf16=False, max_batch=1,
                         frames=16)
    from ttsx_torch.serve import SynthesisRequest
    rng = np.random.default_rng(0)
    ac = srv.cfg.acoustic
    wav = srv.serve_batch([SynthesisRequest(
        text_emb=rng.standard_normal((12, ac.text_emb_dim)).astype(
            np.float32),
        prosody=rng.standard_normal((12, ac.cond_dim)).astype(np.float32),
        emotion_probs=np.full(ac.emotion_dim, 1 / ac.emotion_dim,
                              np.float32),
        speaker=np.zeros(ac.speaker_dim, np.float32), style_id=0)])[0]
    assert wav.shape == (12 * srv.cfg.vocoder.hop_length,)
    assert np.isfinite(wav).all()


def test_record_baseline_has_the_reference_keys(monkeypatch):
    """The reference's ``record`` with stand-in blocks (its keys alone),
    the port's run once per stage at ``TTSXConfig()``."""
    from ttsx.eval import record_baseline as J
    from ttsx.train import blocks as JB
    from ttsx_torch.eval import record_baseline as R

    class Stub:
        def __init__(self, cfg):
            pass

        def init_state(self, rng, batch):
            return None

    for n in ("AcousticBlock", "RefinerBlock", "VocoderBlock"):
        monkeypatch.setattr(JB, n, Stub)
    monkeypatch.setattr(J, "_time", lambda fn, *a, runs=10: 1.0)
    ref = J.record(frames=8, batch=1)
    monkeypatch.setattr(R, "_time", lambda fn, dev, runs=10: (fn(), 1.0)[1])
    got = R.record(frames=8, batch=1, device="cpu")
    assert got.keys() == ref.keys()
    for k in ("acoustic", "refiner", "vocoder"):
        assert got[k].keys() == ref[k].keys(), k
        assert got[k]["peak_mb"] is None
    assert got["unified_iters_per_s"] == ref["unified_iters_per_s"] == 250.0
