"""Stage 1 of the port, the speaker encoder, against ``ttsx`` on the CPU:
``ReferenceEncoder`` (every backbone x every pooling, with and without a
mask), its pooling, ArcFace and GE2E, the EER, one step of each of
``RefEncTrainer``'s three steps, the GE2E grouping, the trainer's loop,
and the data it trains on (``mixup``, ``RefEncDataset``, ``ToneCorpus``).

Tiny widths (ECAPA 32 channels, speaker_dim 32, 40 mel bins). Weights
come from the reference: ``init_like`` trees for the encoder, the
reference trainer's own init for the steps, through ``weights.py``.
Tolerances: embeddings within 1e-5 absolute (unit-norm outputs); losses
1e-5 relative; Adam's first moment after update 1 (0.1 x the clipped
gradient) within 1e-4 relative + 2e-8; after update 2 each parameter
whose gradient is above 1e-6 within 1e-6 (Adam's update there is lr x
sign(g) on both sides), every parameter within 2 lr.
"""
import functools
import json

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
from ttsx_torch.weights import from_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

AU = jc.AudioConfig(sample_rate=16000, n_fft=512, win_length=512,
                    hop_length=128, n_mels=40)
TINY = dict(audio=AU, speaker_dim=32, ecapa_channels=32, conformer_layers=1,
            conformer_heads=2, conformer_ff=32)


def port_cfg(jcfg):
    return tc.from_dict(getattr(tc, type(jcfg).__name__), jc.to_dict(jcfg))


def speaker_batch(seed=0, n_spk=4, m_utt=2, T=16, F=40):
    """Speakers as distinct mel offsets, grouped by speaker."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_spk, F)) * 2
    mel = (protos[np.repeat(np.arange(n_spk), m_utt)][:, None]
           + rng.normal(size=(n_spk * m_utt, T, F)) * 0.3)
    return mel.astype(np.float32), np.repeat(np.arange(n_spk), m_utt)


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("pooling", ["self_attentive", "multi_head_attentive",
                                     "stats"])
@pytest.mark.parametrize("backbone", ["ecapa_tdnn", "res2net", "conformer",
                                      "ssl_host"])
def test_reference_encoder_matches_reference(backbone, pooling):
    from ttsx.models.reference_encoder import ReferenceEncoder as J
    from ttsx_torch.models.reference_encoder import ReferenceEncoder
    jcfg = jc.RefEncConfig(backbone=backbone, pooling=pooling, **TINY)
    x = randn(0, 2, 24, 40)
    mask = np.arange(24)[None] < np.array([[24], [17]])
    jm = J(jcfg)
    tree = _numpy(init_like(jm, jnp.asarray(x), seed=1, scale=0.2))
    pm = port(ReferenceEncoder(port_cfg(jcfg)), tree)
    for m in (None, mask):
        ref = jm.apply(tree, jnp.asarray(x), None if m is None
                       else jnp.asarray(m))
        got = pm(t(x), None if m is None else t(m))
        close(got, ref, 0, 1e-5)
        np.testing.assert_allclose(got.norm(dim=-1).detach().numpy(), 1.0,
                                   atol=1e-5)
    # masked frames do not reach the embedding
    y = x.copy()
    y[1, 17:] = randn(5, 7, 40)
    np.testing.assert_allclose(pm(t(y), t(mask))[1].detach().numpy(),
                               pm(t(x), t(mask))[1].detach().numpy(),
                               atol=1e-6)


# ------------------------------------------------------------------- losses
def test_arcface_and_ge2e_match_reference():
    from ttsx.train import losses as JL
    from ttsx_torch.train import losses as L
    emb, w = randn(0, 8, 32), randn(1, 4, 32)
    labels = np.repeat(np.arange(4), 2)
    for margin in (0.0, 0.3, 0.12):
        close(L.arcface_loss(t(emb), t(labels), t(w), margin, 30.0),
              JL.arcface_loss(jnp.asarray(emb), jnp.asarray(labels),
                              jnp.asarray(w), margin, 30.0), 1e-5, 0)
    for n_spk, m_utt in ((4, 2), (2, 4)):
        lab = np.repeat(np.arange(n_spk), m_utt)
        close(L.ge2e_loss(t(emb), t(lab), torch.tensor(10.0),
                          torch.tensor(-5.0)),
              JL.ge2e_loss(jnp.asarray(emb), jnp.asarray(lab), 10.0, -5.0,
                           n_spk, m_utt), 1e-5, 0)


def test_margin_warmup_matches_reference():
    from ttsx.train.refenc_trainer import RefEncTrainer as J
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    for warmup in (0, 10):
        jcfg = jc.RefEncConfig(arcface_margin_warmup=warmup, **TINY)
        jt, pt = J(jcfg), RefEncTrainer(port_cfg(jcfg), "cpu")
        for step in (0, 1, 3, 7, 10, 100):
            assert pt._margin(step) == float(jt._margin(
                jnp.asarray(step, jnp.int32)))


def test_eer_equals_reference():
    from ttsx.eval.metrics import all_pairs_eer as jeer, compute_eer as jce
    from ttsx_torch.eval.metrics import all_pairs_eer, compute_eer
    emb = randn(0, 24, 16)
    spk = np.repeat(np.arange(6), 4)
    emb += np.eye(6, 16, dtype=np.float32)[spk] * 1.5
    assert all_pairs_eer(emb, spk) == jeer(emb, spk)
    assert compute_eer(np.ones(5), np.ones(5)) == jce(np.ones(5), np.ones(5))


# ------------------------------------------------------------------ trainer
@functools.lru_cache(maxsize=None)
def reference_trainer(**kw):
    """The reference trainer and its initial state (states are values, so
    one serves every test that starts from it)."""
    from ttsx.train.refenc_trainer import RefEncTrainer as J
    jcfg = jc.RefEncConfig(num_speakers=4, lr=1e-2, warmup_steps=2,
                           total_steps=50, **{**TINY, **kw})
    jt = J(jcfg)
    mel, _ = speaker_batch()
    return jt, jt.init_state(jax.random.PRNGKey(0), jnp.asarray(mel))


def trainer_pair(**kw):
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    jt, js = reference_trainer(**kw)
    pt = RefEncTrainer(port_cfg(jt.cfg), "cpu")
    pt.params.load_state_dict(from_flax_params(pt.params, _numpy(js.params)))
    return jt, js, pt


def check_moments(pt, js):
    """Adam's first moments of the two trainers; returns the reference's."""
    mu = from_flax_params(pt.params, _numpy(mu_tree(js.opt_state)))
    adamw = pt.state.tx.adamw
    for n, p in pt.params.named_parameters():
        np.testing.assert_allclose(adamw.state[p]["exp_avg"].numpy(),
                                   mu[n].numpy(), rtol=1e-4, atol=2e-8,
                                   err_msg=n)
    return mu


def check_params(pt, js, mu, lr):
    ref = from_flax_params(pt.params, _numpy(js.params))
    for n, got in pt.params.state_dict().items():
        diff = (got - ref[n]).abs()
        firm = mu[n].abs() > 1e-7
        assert float(torch.where(firm, diff, 0.0).max()) <= 1e-6, n
        assert float(diff.max()) <= 2 * lr + 1e-6, n


def test_train_step_matches_reference():
    """Two ArcFace steps with the margin ramping over 5 updates."""
    jt, js, pt = trainer_pair(arcface_margin_warmup=5)
    for i, seed in enumerate((0, 1)):
        mel, labels = speaker_batch(seed)
        js, jm = jt.train_step(js, jnp.asarray(mel), jnp.asarray(labels))
        pm = pt.train_step(mel, labels)
        close(pm["loss"], jm["loss"], 1e-5, 0)
        if i == 0:
            mu = check_moments(pt, js)
    check_params(pt, js, mu, 1e-2)
    assert pt.state.step == 2 and pt.state.tx.count == 2


def test_mixup_and_accum_steps_match_reference():
    """The steps' own arithmetic, on the cheaper res2net backbone."""
    jt, js, pt = trainer_pair(backbone="res2net")
    mel, labels = speaker_batch(0)
    mel2, labels2 = speaker_batch(1)
    perm = np.random.default_rng(0).permutation(8)
    alpha = np.random.default_rng(1).uniform(0.2, 0.8, 8).astype(np.float32)
    js1, jm = jt.train_step_mixup(
        js, jnp.asarray(mel), jnp.asarray(mel2[perm]), jnp.asarray(labels),
        jnp.asarray(labels2[perm]), jnp.asarray(alpha))
    pm = pt.train_step_mixup(mel, mel2[perm], labels, labels2[perm], alpha)
    close(pm["loss"], jm["loss"], 1e-5, 0)
    check_moments(pt, js1)

    jt, js, pt = trainer_pair(backbone="res2net")
    mels = np.stack([mel, mel2])
    labs = np.stack([labels, labels2])
    js1, jm = jt.train_step_accum(js, jnp.asarray(mels), jnp.asarray(labs))
    pm = pt.train_step_accum(mels, labs)
    close(pm["loss"], jm["loss"], 1e-5, 0)
    check_moments(pt, js1)


def test_ge2e_takes_its_groups_from_the_labels():
    """The reference's trainer groups a GE2E batch as micro_batch // 2
    speakers: a batch of 8 from 2 speakers x 4 utterances is scored as 4
    speakers x 2 (its own loss on the wrong grouping). The port reads 2 x
    4 from the labels, and raises on a batch not grouped by speaker."""
    from ttsx.train import losses as JL
    from ttsx_torch.train.losses import speaker_groups
    jt, js, pt = trainer_pair(loss="ge2e", micro_batch=8, backbone="res2net")
    mel, labels = speaker_batch(0, n_spk=2, m_utt=4)
    params = js.params
    emb = jt.model.apply(params["model"], jnp.asarray(mel))
    w, b = params["ge2e_w"], params["ge2e_b"]
    ref_loss = float(jt._loss(params, jnp.asarray(mel), jnp.asarray(labels),
                              None, js.step))
    wrong = float(JL.ge2e_loss(emb, jnp.asarray(labels), w, b, 4, 2))
    right = float(JL.ge2e_loss(emb, jnp.asarray(labels), w, b, 2, 4))
    assert ref_loss == pytest.approx(wrong, rel=1e-6)
    assert abs(wrong - right) > 1e-3
    got = pt.train_step(mel, labels)["loss"]
    assert float(got) == pytest.approx(right, rel=1e-5)
    assert speaker_groups(torch.tensor([3, 3, 1, 1, 0, 0])) == (3, 2)
    for bad in ([0, 1, 0, 1, 2, 2, 3, 3], [0, 0, 0, 1, 1], [0, 0, 1, 1, 0, 0],
                [0, 1, 2, 3], [2, 2, 2, 2]):
        with pytest.raises(ValueError, match="grouped by speaker"):
            pt.train_step(mel[:len(bad)], bad)


def test_train_loop_order_and_checkpoints(tmp_path):
    """The reference's loop: the max_steps break comes before the
    evaluation; ``best`` on a lower EER, ``final`` at the end, both with
    ``{"best_eer"}`` and the reference's meta keys; the state restores."""
    from ttsx_torch.train.checkpoint import restore_checkpoint
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    cfg = port_cfg(jc.RefEncConfig(num_speakers=4, eval_every=1, lr=1e-2,
                                   warmup_steps=1, backbone="res2net",
                                   **TINY))
    tr = RefEncTrainer(cfg, "cpu")
    eers = iter([0.4, 0.3, 0.35, 0.1])
    seen = []

    def eval_fn(trainer):
        seen.append(trainer.state.step)
        return next(eers)
    out = tr.train((speaker_batch(s) for s in range(6)), eval_fn,
                   max_steps=4, checkpoint_dir=str(tmp_path))
    assert out["steps"] == 4 and seen == [1, 2, 3]
    assert out["best_eer"] == 0.3
    best = json.loads((tmp_path / "best" / "meta.json").read_text())
    final = json.loads((tmp_path / "final" / "meta.json").read_text())
    assert best == {"step": 2, "extra": {"best_eer": 0.3}}
    assert final == {"step": 4, "extra": {"best_eer": 0.3}}
    fresh = RefEncTrainer(cfg, "cpu", seed=5)
    states, step, _ = restore_checkpoint(str(tmp_path), "final",
                                         {"refenc": fresh.state.state_dict()})
    fresh.state.load_state_dict(states["refenc"])
    mel, _ = speaker_batch(9)
    assert torch.equal(fresh.embed(mel), tr.embed(mel))
    assert fresh.state.step == 4


# --------------------------------------------------------------------- data
def test_mixup_matches_reference():
    from ttsx.data.collate import mixup as jmixup
    from ttsx_torch.data.collate import mixup
    mel, labels = speaker_batch(0)
    got = mixup(mel, labels, np.random.default_rng(3))
    ref = jmixup(mel, labels, np.random.default_rng(3))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_refenc_dataset_matches_reference(tmp_path):
    """Same seed: the same crops, augments and SpecAugment masks (the
    wavs equal, the mels within f32 FFT rounding, the masks in the same
    places); eval items uncropped."""
    from ttsx.data.refenc_dataset import RefEncDataset as J
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.data.refenc_dataset import RefEncDataset
    audio = tc.AudioConfig(sample_rate=16000, n_fft=512, win_length=512,
                           hop_length=128, n_mels=40, mel_normalize=False)
    jaudio = jc.from_dict(jc.AudioConfig, tc.to_dict(audio))
    rng = np.random.default_rng(0)
    items = []
    for i, spk in enumerate(("b", "a", "b")):
        path = tmp_path / f"u{i}.wav"
        n = int(16000 * (1.5 + 2 * i))
        write_wav(path, (0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
                         + 0.05 * rng.standard_normal(n)).astype(np.float32),
                  16000)
        items.append((str(path), spk))
    for train in (True, False):
        for return_mel in (False, True):
            pd = RefEncDataset(items, audio, train=train, seed=7,
                               return_mel=return_mel, device="cpu")
            jd = J(items, jaudio, train=train, seed=7, return_mel=return_mel)
            assert pd.speaker_ids == jd.speaker_ids == [1, 0, 1]
            for _ in range(2):
                for i in range(len(items)):
                    (g, gl), (r, rl) = pd[i], jd[i]
                    assert gl == rl and g.shape == r.shape
                    if return_mel:
                        np.testing.assert_array_equal(g == 0, r == 0)
                        np.testing.assert_allclose(g, r, atol=2e-4)
                    else:
                        np.testing.assert_array_equal(g, r)


def test_tone_corpus_matches_reference():
    from ttsx.data.tonecorpus import ToneCorpus as J
    from ttsx_torch.data.tonecorpus import ToneCorpus
    kw = dict(n_speakers=3, n_phonemes=5, text_dim=8, seed=4,
              intonation=0.2, noise_db=20.0)
    pc, jcorp = ToneCorpus(**kw), J(**kw)
    for k in ("spk_f0", "spk_env", "pho_mask", "pho_am", "pho_emb"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jcorp, k))
    pu = pc.utterances(2, 24, seed=1)
    ju = jcorp.utterances(2, 24, seed=1)
    for a, b in zip(pu, ju):
        np.testing.assert_array_equal(a.wav, b.wav)
        np.testing.assert_array_equal(a.phoneme_ids, b.phoneme_ids)
    got, ref = pc.features(pu[:3], device="cpu"), jcorp.features(ju[:3])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    for k in ("wav", "text_emb", "speaker_id", "style_id", "emotion_probs",
              "frame_mask"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-4)
    np.testing.assert_allclose(got["f0"], ref["f0"], rtol=1e-5)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["prosody"], ref["prosody"], atol=1e-4)
    wav, segs = pc.dialogue([0, 1], 3, seed=2)
    jwav, jsegs = jcorp.dialogue([0, 1], 3, seed=2)
    np.testing.assert_array_equal(wav, jwav)
    assert segs == jsegs
    got = pc.dialogue_hard([0, 1, 2], 4, noise_db=15.0, seed=3)
    ref = jcorp.dialogue_hard([0, 1, 2], 4, noise_db=15.0, seed=3)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]


def test_zoo_stage_loaders_load_whole_and_refuse_a_missing_export(tmp_path):
    """``load_refenc`` / ``load_prosody`` on the checked-in zoo at full
    width with numpy alone: every value of the exports lands (3.37 M and
    0.78 M), the configs are the exports'; a missing export raises (the
    reference returns ``(None, None)``)."""
    from ttsx_torch.zoo import load_prosody, load_refenc
    tr, enc = load_refenc(device="cpu")
    assert (tr.cfg.num_speakers, tr.cfg.loss, tr.cfg.ecapa_channels) == (
        12, "arcface", 512)
    assert sum(p.numel() for p in tr.params.parameters()) == 3_366_084
    assert enc is tr.model and not enc.cfg.audio.mel_normalize
    tr, pred = load_prosody(device="cpu")
    assert (tr.cfg.cond_dim, tr.cfg.n_layers, tr.cfg.s4.causal) == (
        256, 4, False)
    assert sum(p.numel() for p in pred.parameters()) == 778_002
    for load in (load_refenc, load_prosody):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path), device="cpu")
