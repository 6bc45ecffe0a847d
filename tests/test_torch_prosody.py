"""Stage 2 of the port, the prosody predictor and the emotion head,
against ``ttsx`` on the CPU: ``ProsodyPredictor`` (T below ``n_freq``,
past it and past the S4 ``l_max``, with and without a mask) and
``pack_prosody``, ``prosody_loss``, ``targets_from_wav`` and ``mfcc``,
one step of ``ProsodyTrainer`` and of ``EmotionTrainer``,
``assign_emotion_tags``, and the DSP pieces ``istft`` and ``energy_vad``.

Tiny widths (cond_dim 32, 2 S4 layers of 2 heads, 40 mel bins). Weights
come from the reference (``init_like`` trees; the trainers' own init),
through ``weights.py``. Tolerances: predictor outputs within 1e-5
absolute + 1e-5 relative (the S4 layers' FFT convolutions round
differently in the two packages); losses 1e-5 relative; Adam's first
moment after update 1 within 1e-4 relative + 2e-8, as in
``test_torch_refenc.py``; DSP features 1e-5 relative or 1e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close, init_like, port, randn, t
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_train_helpers import _numpy, mu_tree

from ttsx.core import config as jc
from ttsx_torch.core import config as tc
from ttsx_torch.weights import from_flax, from_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

AU = jc.AudioConfig(sample_rate=16000, n_fft=512, win_length=512,
                    hop_length=128, n_mels=40, mel_normalize=False)
CFG = jc.ProsodyConfig(
    audio=AU, mel_dim=40, cond_dim=32, n_layers=2, n_freq=16, mfcc_weight=0.05,
    s4=jc.S4Config(heads=2, l_max=32, causal=False, norm_groups=4))
OUT_TOL = (1e-5, 1e-5)


def port_cfg(jcfg):
    return tc.from_dict(getattr(tc, type(jcfg).__name__), jc.to_dict(jcfg))


def tone_wav(B=2, seconds=0.6, sr=16000, seed=0):
    """Glides with pauses and a little noise: voiced and unvoiced frames."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    out = []
    for b in range(B):
        f0 = (140 + 40 * b) * (1 + 0.2 * np.sin(2 * np.pi * 2 * tt))
        env = (np.sin(2 * np.pi * (3 + b) * tt) > -0.3).astype(np.float64)
        wav = 0.4 * env * np.sin(2 * np.pi * np.cumsum(f0) / sr)
        out.append(wav + 0.01 * rng.standard_normal(n))
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------- predictor
@pytest.mark.parametrize("T", [12, 20, 40])
def test_predictor_and_pack_match_reference(T):
    """T = 12 crops the 16-row sinusoidal table, 20 tail-extends it, 40
    also runs past the S4 l_max of 32."""
    from ttsx.models.prosody import ProsodyPredictor as J
    from ttsx.models.prosody import pack_prosody as jpack
    from ttsx_torch.models.prosody import ProsodyPredictor, pack_prosody
    x = randn(0, 2, T, 40)
    mask = np.arange(T)[None] < np.array([[T], [T - 5]])
    jm = J(CFG)
    tree = _numpy(init_like(jm, jnp.asarray(x), seed=2, scale=0.2))
    pm = port(ProsodyPredictor(port_cfg(CFG)), tree)
    for m in (None, mask):
        ref = jm.apply(tree, jnp.asarray(x), None if m is None
                       else jnp.asarray(m))
        got = pm(t(x), None if m is None else t(m))
        assert set(got) == set(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape, k
            close(got[k], ref[k], *OUT_TOL)
        close(pack_prosody(got), jpack(ref), *OUT_TOL)
    assert pack_prosody(got).shape == (2, T, 18)


def test_prosody_loss_matches_reference():
    from ttsx.train.losses import prosody_loss as jloss
    from ttsx_torch.train.losses import prosody_loss
    rng = np.random.default_rng(0)
    shapes = {"f0": (2, 9), "energy": (2, 9), "pitch_var": (2, 9),
              "speech_rate": (2, 1), "pause_dur": (2, 1), "mfcc": (2, 13)}
    pred = {k: (rng.normal(size=s) * 2).astype(np.float32)
            for k, s in shapes.items()}
    target = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    weights = {"f0": 1.0, "energy": 0.5, "mfcc": 0.05}
    mask = rng.random((2, 9)) < 0.6
    for m in (None, mask):
        for w in (None, weights):
            got = prosody_loss({k: t(v) for k, v in pred.items()},
                               {k: t(v) for k, v in target.items()}, w,
                               None if m is None else t(m))
            ref = jloss({k: jnp.asarray(v) for k, v in pred.items()},
                        {k: jnp.asarray(v) for k, v in target.items()}, w,
                        None if m is None else jnp.asarray(m))
            close(got, ref, 1e-6, 0)


def test_targets_and_mfcc_match_reference():
    from ttsx.dsp import mfcc as jmfcc
    from ttsx.train.prosody_trainer import ProsodyTrainer as J
    from ttsx_torch.dsp.stft import mfcc
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    wav = tone_wav()
    close(mfcc(t(wav), port_cfg(AU)), jmfcc(jnp.asarray(wav), AU), 1e-5, 1e-4)
    frames = 70
    got = ProsodyTrainer.targets_from_wav(t(wav), port_cfg(CFG), frames)
    ref = J.targets_from_wav(jnp.asarray(wav), CFG, frames)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        close(got[k], ref[k], 1e-5, 1e-4)
    voiced = float((got["f0"] != 0).float().mean())
    assert 0.2 < voiced < 0.95          # both kinds of frame are exercised


def test_prosody_train_step_matches_reference():
    from ttsx.train.prosody_trainer import ProsodyTrainer as J
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    wav = tone_wav()
    frames = 24
    mel = randn(3, 2, frames, 40)
    mask = np.arange(frames)[None] < np.array([[frames], [frames - 6]])
    jt = J(CFG)
    js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(mel))
    pt = ProsodyTrainer(port_cfg(CFG), device="cpu")
    pt.model.load_state_dict(from_flax(pt.model, _numpy(js.params)))
    targets = {k: v.numpy() for k, v in ProsodyTrainer.targets_from_wav(
        t(wav), port_cfg(CFG), frames).items()}
    js, jm = jt.train_step(js, jnp.asarray(mel),
                           {k: jnp.asarray(v) for k, v in targets.items()},
                           jnp.asarray(mask))
    pm = pt.train_step(mel, targets, mask)
    close(pm["loss"], jm["loss"], 1e-5, 0)
    mu = from_flax(pt.model, {"params": _numpy(mu_tree(js.opt_state))[
        "params"]})
    adamw = pt.state.tx.adamw
    for n, p in pt.model.named_parameters():
        np.testing.assert_allclose(adamw.state[p]["exp_avg"].numpy(),
                                   mu[n].numpy(), rtol=1e-4, atol=2e-8,
                                   err_msg=n)
    close(pt.val_step(mel, targets, mask),
          jt.val_step(js.params, jnp.asarray(mel),
                      {k: jnp.asarray(v) for k, v in targets.items()},
                      jnp.asarray(mask)), 1e-5, 0)


# ------------------------------------------------------------------ emotion
def test_emotion_train_step_matches_reference():
    """The gate blend and classifier (two transformer layers over a
    length-1 sequence) and one BCE step."""
    from ttsx.train.emotion_trainer import EmotionTrainer as J
    from ttsx_torch.train.emotion_trainer import EmotionTrainer
    rng = np.random.default_rng(0)
    vader = rng.normal(size=(8, 4)).astype(np.float32)
    pvec = rng.normal(size=(8, 19)).astype(np.float32)
    targets = (rng.random((8, 6)) > 0.7).astype(np.float32)
    jt = J()
    js = jt.init_state(jax.random.PRNGKey(0))
    params = _numpy(js.params)
    params["classifier"]["params"] = _numpy(jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        params["classifier"]["params"]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    pt = EmotionTrainer(device="cpu")
    pt.params.load_state_dict(from_flax_params(pt.params, params))
    close(pt.predict(t(vader), t(pvec)),
          jt.predict(params, jnp.asarray(vader), jnp.asarray(pvec)), 1e-5,
          1e-6)
    js, jm = jt.train_step(js, jnp.asarray(vader), jnp.asarray(pvec),
                           jnp.asarray(targets))
    pm = pt.train_step(vader, pvec, targets)
    close(pm["loss"], jm["loss"], 1e-5, 0)
    mu = from_flax_params(pt.params, _numpy(mu_tree(js.opt_state)))
    adamw = pt.state.tx.adamw
    for n, p in pt.params.named_parameters():
        np.testing.assert_allclose(adamw.state[p]["exp_avg"].numpy(),
                                   mu[n].numpy(), rtol=1e-4, atol=2e-8,
                                   err_msg=n)


def test_assign_emotion_tags_matches_reference():
    from ttsx.models.prosody import assign_emotion_tags as jtags
    from ttsx_torch.models.prosody import EMOTIONS, assign_emotion_tags
    probs = np.random.default_rng(0).random((5, 6)).astype(np.float32)
    assert assign_emotion_tags(t(probs)) == jtags(jnp.asarray(probs))
    assert assign_emotion_tags(probs)[0] == tuple(
        EMOTIONS[i] for i in np.argsort(-probs[0])[:2])


# ---------------------------------------------------------------------- DSP
def test_istft_and_energy_vad_match_reference():
    from ttsx.dsp.features import energy_vad as jvad
    from ttsx.dsp.stft import istft as jistft
    from ttsx_torch.dsp.features import energy_vad
    from ttsx_torch.dsp.stft import istft, stft_magnitude
    rng = np.random.default_rng(0)
    mag = rng.random((2, 7, 129)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 7, 129)).astype(np.float32)
    got = istft(t(mag), t(phase), 256, 64)
    ref = jistft(jnp.asarray(mag), jnp.asarray(phase), 256, 64)
    assert tuple(got.shape) == ref.shape == (2, 6 * 64)
    close(got, ref, 1e-5, 1e-6)
    wav = tone_wav()
    cfg = port_cfg(AU)
    for thr in (0.02, 0.3):
        got = energy_vad(t(wav), cfg, thr)
        ref = jvad(jnp.asarray(wav), AU, thr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < float(got.float().mean()) < 1
    # a clean centred STFT inverts back to its wav away from the ends
    x = torch.as_tensor(tone_wav(1, 0.2))
    spec = torch.stft(x, 256, 64, window=torch.hann_window(256),
                      return_complex=True).transpose(1, 2)
    back = istft(spec.abs(), spec.angle(), 256, 64)
    n = back.shape[1]
    close(back[:, 256:n - 256], x[:, 256:n - 256], 0, 1e-4)
    assert stft_magnitude(x, 256, 64).shape == spec.shape
