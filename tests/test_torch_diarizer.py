"""The speaker diarizer of the port (``ttsx_torch.pipeline.diarizer``)
against the reference (``ttsx.pipeline.diarizer``) on the CPU.

Continuous outputs (STFT-based VAD probabilities, embeddings, losses) are
held to 1e-5; the numpy stages, which are copies, must give equal
outputs on equal inputs; end to end the slices, the speaker partition,
the overlaps, the RTTM text, the rebuilt wavs and the DER must be equal.
Inputs come from a numpy seed or from ``eval_results/diar_embs.npz`` (the
hard benchmark stream: 81.3 s, 6 speakers, 12 dB SNR, with the
reference's VAD slices, 1 s windows and window embeddings). Weights
reach the port from the reference's trees; the reference's slice
encoder is applied under ``jax.jit`` (``jitted``: the same function,
compiled once per batch shape, where eager dispatch compiles each op
and takes about 6 s a shape on one core). New speakers are named from
``uuid.uuid4``: inside these tests it is a counter, restarted for each
package, so both name their speakers alike.
"""
from __future__ import annotations

import json
import logging
import types
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401
from torch_parity_helpers import (Names as _Names, jitted, same,
                                  tiny_encoder, to_numpy, two_speaker_wav)

import ttsx.core.config as rcfg
import ttsx.data.dataset as rdata
import ttsx.eval.metrics as rmetrics
import ttsx.pipeline.diarizer.cluster as rcluster
import ttsx.pipeline.diarizer.controller as rcontroller
import ttsx.pipeline.diarizer.gnn as rgnn
import ttsx.pipeline.diarizer.offline as roffline
import ttsx.pipeline.diarizer.overlap as roverlap
import ttsx.pipeline.diarizer.overlap_net as roverlap_net
import ttsx.pipeline.diarizer.rebuilder as rrebuilder
import ttsx.pipeline.diarizer.slicer as rslicer
from ttsx.data.tonecorpus import ToneCorpus as RToneCorpus
from ttsx.models.reference_encoder import ReferenceEncoder as RReferenceEncoder
from ttsx.pipeline.diarizer.embedding import SliceEmbedder as RSliceEmbedder

import ttsx_torch.core.config as pcfg
import ttsx_torch.eval.metrics as pmetrics
import ttsx_torch.pipeline.diarizer.cluster as pcluster
import ttsx_torch.pipeline.diarizer.controller as pcontroller
import ttsx_torch.pipeline.diarizer.gnn as pgnn
import ttsx_torch.pipeline.diarizer.offline as poffline
import ttsx_torch.pipeline.diarizer.overlap as poverlap
import ttsx_torch.pipeline.diarizer.overlap_net as poverlap_net
import ttsx_torch.pipeline.diarizer.rebuilder as prebuilder
import ttsx_torch.pipeline.diarizer.slicer as pslicer
from ttsx_torch.pipeline.diarizer.embedding import SliceEmbedder as PSliceEmbedder
from ttsx_torch.weights import from_flax, to_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
DUMP = REPO / "eval_results/diar_embs.npz"
# the production controller (parity_diar.py:127-132) with the zoo's
# diar_encoder.npz on the dump's stream: parity_diar.json
# diarizer_hard.trained, which the reference reproduces on the CPU
ZOO_DER, ZOO_DER_COLLAR, ZOO_SPEAKERS, ZOO_SEGMENTS = 0.27676, 0.17144, 5, 60
# the offline recipe on the dump (the reference's evaluate_dump)
OFFLINE = {"der": 0.1685, "der_collar": 0.0416, "k": 5, "k_true": 6,
           "n_segs": 58}
EMB_TOL = 1e-5
PROD = dict(min_dur=0.8, max_dur=3.0, cluster_method="spectral",
            subsegment_s=1.0, cluster_merge_thresh=0.75)

REF = types.SimpleNamespace(
    name="ref", cluster=rcluster, slicer=rslicer, overlap=roverlap,
    controller=rcontroller, rebuilder=rrebuilder, offline=roffline,
    metrics=rmetrics, gnn=rgnn, data=rdata, cfg=rcfg, dev={})
PORT = types.SimpleNamespace(
    name="port", cluster=pcluster, slicer=pslicer, overlap=poverlap,
    controller=pcontroller, rebuilder=prebuilder, offline=poffline,
    metrics=pmetrics, gnn=pgnn, data=rdata, cfg=pcfg,
    dev={"device": "cpu"})
PKGS = (REF, PORT)


@pytest.fixture
def names(monkeypatch):
    """Call before each package's run: new speakers are spk-00000001, ..."""
    return lambda: monkeypatch.setattr(uuid, "uuid4", _Names())


@pytest.fixture(scope="module")
def dump():
    return np.load(DUMP, allow_pickle=True)


def _audio(pkg, **kw):
    return pkg.cfg.AudioConfig(**kw)


def embedders(au_kw=None, **kw):
    cfg_kw, tree = tiny_encoder()
    au_kw = au_kw or {}
    ref = jitted(RSliceEmbedder(rcfg.AudioConfig(**au_kw),
                                rcfg.RefEncConfig(**cfg_kw), params=tree,
                                **kw))
    port = PSliceEmbedder(pcfg.AudioConfig(**au_kw),
                          pcfg.RefEncConfig(**cfg_kw), params=tree,
                          device="cpu", **kw)
    return ref, port


# ------------------------------------------------------------ embeddings
def test_slice_embedder_matches_reference():
    """The tiny encoder with the reference's weights, on 4 slices of the
    8 s wav (the normalized mel for the encoder, the raw one for the
    voiceprint; one slice longer than max_frames): within 1e-5."""
    wav, _ = two_speaker_wav()
    slices = [(0.2, 1.4), (1.5, 2.3), (2.9, 6.4), (6.6, 7.9)]
    ref, port = embedders()
    want, got = ref.extract(wav, slices), port.extract(wav, slices)
    assert got.shape == want.shape == (4, 32 + 160)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert port.extract(wav, []).shape == (0, 32)


def test_zoo_diar_encoder_matches_reference(dump):
    """The port's ``load_diar_encoder`` on 8 of the dump's windows against
    the reference's ``SliceEmbedder`` on the export's tree with the
    export's config (the reference's own loader spends ~9 s building a
    trainer for its template; both loaders meet on all 81 windows in
    the slow ``test_zoo_production_controller_equals_reference``)."""
    from ttsx.eval.parity_common import AUDIO as RAUDIO
    from ttsx_torch.weights import load_slim_npz
    from ttsx_torch.zoo import DEFAULT_ZOO, load_diar_encoder
    wins = [tuple(w) for w in dump["win_plain"][::10][:8]]
    port = load_diar_encoder(device="cpu")
    got = port.extract(dump["wav"], wins)
    trees = load_slim_npz(str(DEFAULT_ZOO / "diar_encoder.npz"))
    meta = trees["_meta"]
    cfg = rcfg.RefEncConfig(audio=RAUDIO, speaker_dim=int(meta["speaker_dim"]),
                            ecapa_channels=int(meta["ecapa_channels"]),
                            num_speakers=int(meta["num_speakers"]))
    want = jitted(RSliceEmbedder(RAUDIO, cfg=cfg, params=trees["refenc"])
                  ).extract(dump["wav"], wins)
    assert port.spec_weight == 0.5 and got.shape == (8, 352)
    assert port.cfg == pcfg.from_dict(pcfg.RefEncConfig, rcfg.to_dict(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)


def test_load_diar_encoder_raises_on_a_missing_export(tmp_path):
    """The reference returns None; the port raises, as its other loaders."""
    from ttsx.zoo import load_diar_encoder as ref_load
    from ttsx_torch.zoo import load_diar_encoder
    assert ref_load(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="diar_encoder"):
        load_diar_encoder(str(tmp_path), device="cpu")


def test_untrained_embedder_draws_its_own_init(monkeypatch):
    """Departure (watch-list): without weights the reference initializes
    its encoder with ``model.init(jax.random.PRNGKey(seed), ...)``, the
    port with flax's initializers drawn from
    ``torch.Generator().manual_seed(seed)``, so an untrained port
    embedder does not give the reference's embeddings (the tests carry
    the reference's tree across instead). Each is deterministic."""
    from ttsx_torch.models.reference_encoder import ReferenceEncoder
    from ttsx_torch.nn.init import fresh_init_
    cfg_kw, tree = tiny_encoder()
    keys = []

    def init(self, key, dummy):
        keys.append(np.asarray(key))
        return tree

    monkeypatch.setattr(RReferenceEncoder, "init", init)
    ref = RSliceEmbedder(rcfg.AudioConfig(), rcfg.RefEncConfig(**cfg_kw),
                         seed=3)
    ref._ensure_model(80)
    np.testing.assert_array_equal(keys[0], jax.random.PRNGKey(3))
    assert ref._params is tree and ref.spec_weight == 2.0
    wav, _ = two_speaker_wav()
    slices = [(0.2, 1.4), (2.9, 4.4), (6.6, 7.9)]
    port = PSliceEmbedder(pcfg.AudioConfig(), pcfg.RefEncConfig(**cfg_kw),
                          seed=3, device="cpu")
    emb = port.extract(wav, slices)
    want = fresh_init_(ReferenceEncoder(pcfg.RefEncConfig(**cfg_kw)),
                       torch.Generator().manual_seed(3)).state_dict()
    got = port._model.state_dict()
    assert port.spec_weight == 2.0 and got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(emb, PSliceEmbedder(
        pcfg.AudioConfig(), pcfg.RefEncConfig(**cfg_kw), seed=3,
        device="cpu").extract(wav, slices))


# ----------------------------------------------------------------- slicer
def test_vad_and_slices_match_reference(dump):
    """VAD probabilities within 1e-5 on the dump's stream; the slices and
    1 s windows equal the reference's on the CPU and the dump's own
    (which the reference made on its accelerator)."""
    from ttsx.eval.parity_common import AUDIO as RAUDIO
    from ttsx_torch.zoo import AUDIO
    wav = dump["wav"]
    want = rslicer.vad_probabilities(wav, RAUDIO)
    got = pslicer.vad_probabilities(wav, AUDIO, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the thresholds' margins: no probability near 0.5 or the snap's 0.25
    for th in (0.5, 0.25):
        assert np.abs(got - th).min() > 1e-3
    ref_s, ref_stats = rslicer.dynamic_slice(wav, RAUDIO, 0.8, 3.0)
    got_s, got_stats = pslicer.dynamic_slice(wav, AUDIO, 0.8, 3.0,
                                             device="cpu")
    same(got_s, ref_s)
    np.testing.assert_array_equal(np.asarray(got_s), dump["slices_raw"])
    ctl = pcontroller.DiarizerController(AUDIO, subsegment_s=1.0,
                                         device="cpu")
    wins = ctl._explode(got_s)
    same(wins, rcontroller.DiarizerController(
        RAUDIO, subsegment_s=1.0)._explode(ref_s))
    np.testing.assert_array_equal(np.asarray(wins), dump["win_plain"])
    assert got_stats.keys() == ref_stats.keys()
    assert got_stats["n_slices"] == ref_stats["n_slices"] == 27


# ------------------------------------------------------ the numpy stages
def _embs(seed=0, n_spk=3, per=8, dim=16):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_spk, dim))
    lab = np.repeat(np.arange(n_spk), per)
    rng.shuffle(lab)
    e = centers[lab] + 0.6 * rng.normal(size=(len(lab), dim))
    starts = np.sort(rng.uniform(0, 60, len(lab)))
    probs = rng.uniform(0.5, 1.0, len(lab))
    wins = [(float(s), float(s) + float(d)) for s, d in
            zip(starts, rng.uniform(0.5, 2.0, len(lab)))]
    return e, lab, starts, probs, wins


def _segments(seed):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(12):
        d = float(rng.uniform(0.5, 3.0))
        s = max(t - float(rng.uniform(0, 0.4)), 0.0)
        out.append((round(s, 3), round(s + d, 3), f"s{rng.integers(3)}"))
        t = s + d
    return out


def _reid(P):
    mem = P.cluster.ReIDMemory()
    e, lab, *_ = _embs(1, n_spk=4, per=6, dim=12)
    out = []
    for job in range(8):
        rng = np.random.default_rng(job)
        noisy = e + 0.3 * rng.normal(size=e.shape)
        out.append(mem.re_id({int(c): noisy[lab == c]
                              for c in np.unique(lab)}))
    out.append(mem.match_threshold)
    spk = sorted(mem.prototypes)
    mem.update(spk[0], e[0])
    mem.update("spk-new", e[1])
    mem.contrastive_refresh(e[:6], [spk[0], spk[1], "x", spk[2], spk[0],
                                    "spk-new"])
    return out + [{k: v for k, v in mem.prototypes.items()},
                  {k: list(v) for k, v in mem.memory.items()}]


def _reid_snapshot(P, path):
    mem = P.cluster.ReIDMemory(auto_tune=False, match_threshold=0.7)
    e, lab, *_ = _embs(2, dim=8)
    mem.re_id({int(c): e[lab == c] for c in np.unique(lab)})
    mem.snapshot(str(path))
    back = P.cluster.ReIDMemory(memory_size=3)
    back.load_snapshot(str(path))
    return [back.match_threshold, back.prototypes,
            {k: (list(v), v.maxlen) for k, v in back.memory.items()}]


def _screen(w):
    """A deterministic stand-in for the learned screen."""
    return float(np.clip(np.abs(w).mean() * 8.0, 0.0, 1.0))


def _dump_labels(dump):
    return rcluster.spectral_cluster(dump["emb_plain"])


CASES = {
    "time_aware_sim": lambda P, d, t: P.cluster.time_aware_sim(
        *(_embs()[i] for i in (0, 2, 3))),
    "modularity": lambda P, d, t: P.cluster.GreedyModularityClusterer(
        0.4).cluster(P.cluster.time_aware_sim(_embs()[0], _embs()[2])),
    "kmeans": lambda P, d, t: [
        P.cluster.KMeansClusterer(seed=1).cluster_embeddings(_embs()[0]),
        P.cluster.KMeansClusterer(k=3).cluster(
            P.cluster.time_aware_sim(_embs()[0], _embs()[2]))],
    "spectral": lambda P, d, t: [
        P.cluster.spectral_cluster(_embs()[0]),
        P.cluster.spectral_cluster(_embs()[0], k=4, prune_pct=0.0),
        P.cluster.spectral_cluster(d["emb_plain"])],
    "temporal_cluster": lambda P, d, t: [
        P.cluster.temporal_cluster(_embs()[0], _embs()[2], method=m)
        for m in ("modularity", "kmeans", "spectral")],
    "merge_clusters": lambda P, d, t: [
        P.cluster.merge_clusters(_embs()[0], np.arange(24) % 7, th)
        for th in (0.3, 0.75)],
    "stitch_segments": lambda P, d, t: P.cluster.stitch_segments(
        [tuple(w) for w in d["win_plain"]], _dump_labels(d), d["emb_plain"]),
    "tcn_and_smoothing": lambda P, d, t: [
        P.cluster.ReIDMemory.tcn_context(_embs()[0], _embs()[2]),
        P.cluster.ReIDMemory.smooth_labels(_embs()[1], _embs()[2]),
        P.cluster.ReIDMemory.smooth_labels(_embs()[1], _embs()[2],
                                           _embs()[0])],
    "reid_memory": lambda P, d, t: _reid(P),
    "reid_snapshot": lambda P, d, t: _reid_snapshot(P, t / f"{P.name}.pkl"),
    "gnn_forward": lambda P, d, t: P.gnn.GNNClusterer(
        dim=16, seed=2).cluster_embeddings(d["emb_plain"]),
    "trim_cross_speaker_overlaps": lambda P, d, t:
        P.controller.trim_cross_speaker_overlaps(
            [tuple(w) for w in d["slices_raw"]],
            [f"s{i % 3}" for i in range(27)]),
    "speech_mask_and_clip": lambda P, d, t: [
        P.slicer.speech_mask(d["wav"], _audio(P)),
        P.slicer.speech_mask(np.ones(44100, np.float32), _audio(P)),
        P.slicer.clip_segments(
            [tuple(w) for w in d["win_plain"]], list(range(81)),
            P.slicer.speech_mask(d["wav"], _audio(P)))],
    "split_slices_at_overlaps": lambda P, d, t:
        P.overlap.split_slices_at_overlaps(
            [tuple(w) for w in d["slices_raw"]],
            [tuple(r) for r in d["regions"]]),
    "detect_overlaps_heuristic": lambda P, d, t: P.overlap.detect_overlaps(
        d["wav"], _audio(P), [tuple(w) for w in d["win_plain"]],
        _dump_labels(d), d["emb_plain"], sim_thresh=0.9, **P.dev),
    "screen_stream_and_screened_overlaps": lambda P, d, t: [
        P.overlap.screen_stream(d["wav"], _audio(P), _screen,
                                [tuple(w) for w in d["slices_raw"]]),
        P.overlap.detect_overlaps(
            d["wav"], _audio(P), [tuple(w) for w in d["win_plain"]],
            _dump_labels(d), d["emb_plain"], screen=_screen)],
    "der_purity_silhouette": lambda P, d, t: [
        P.metrics.diarization_error_rate(_segments(0), _segments(1)),
        P.metrics.diarization_error_rate(_segments(0), _segments(1),
                                         collar=0.25),
        P.metrics.diarization_error_rate(_segments(2), _segments(2)[::2]),
        P.metrics.cluster_purity(_embs()[1], np.arange(24) % 4),
        P.metrics.silhouette_score(_embs()[0], _embs()[1])],
    "offline_cluster_windows": lambda P, d, t: P.offline.cluster_windows(
        [tuple(w) for w in d["win_plain"]], d["emb_plain"], wav=d["wav"],
        au=_audio(P, mel_normalize=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_stage_equals_reference(case, dump, tmp_path, names):
    """Each numpy stage of the diarizer gives the reference's output
    exactly on the same inputs (the STFT-based flux of the overlap
    heuristic included: its outputs are rounded to 3 decimals)."""
    outs = []
    for P in PKGS:
        names()
        outs.append(CASES[case](P, dump, tmp_path))
    same(outs[1], outs[0])


def test_rttm_and_rebuild_equal_reference(tmp_path, dump):
    wav = dump["wav"][:22050 * 12]
    slices = [(0.5, 2.25), (2.0, 4.0), (4.5, 7.0), (7.2, 11.0)]
    spk = ["a", "b", "a", "c"]
    ovs = [(1.9, 2.3, 0, 1, 0.5)]
    ov_spk = [(1.9, 2.3, "a", "b", 0.5), (8.0, 8.4, "c", "b", 0.7)]
    for P in PKGS:
        P.rebuilder.reconstruct_audio(
            wav, _audio(P), tmp_path / P.name, "job", slices, spk, ovs,
            overlap_speakers=ov_spk)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def _tree(root: Path):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_evaluate_dump_matches_reference():
    got = poffline.evaluate_dump(str(DUMP))
    assert got == roffline.evaluate_dump(str(DUMP)) == OFFLINE
    assert got["der"] <= 0.20 and got["der_collar"] <= 0.08


# ------------------------------------------------- learned components
def _windows(P, corpus, n, seed):
    return P.overlap_net.make_overlap_windows(corpus, _audio(
        P, mel_normalize=False), n, seed=seed, **P.dev)


def test_overlap_net_matches_reference(dump, monkeypatch):
    """Forward on a batch of windows, 3 Adam steps from the reference's
    init on the same batches, and the screen on windows of the stream:
    within 1e-5; the same accuracies."""
    from ttsx_torch.data.tonecorpus import ToneCorpus
    ref_corpus = RToneCorpus(n_speakers=4, audio=rcfg.AudioConfig(
        mel_normalize=False))
    corpus = ToneCorpus(n_speakers=4, audio=pcfg.AudioConfig(
        mel_normalize=False))
    au = pcfg.AudioConfig(mel_normalize=False)
    rau = rcfg.AudioConfig(mel_normalize=False)
    kw = dict(steps=3, batch=8, n_train=16, seed=0)
    windows, inits = {}, []
    make, init = roverlap_net.make_overlap_windows, roverlap_net.OverlapNet.init

    def ref_windows(corpus_, audio, n, seed=0):
        windows[seed] = make(corpus_, audio, n, seed)
        return windows[seed]

    def ref_init(self, *a):
        inits.append(to_numpy(init(self, *a)))
        return inits[-1]

    monkeypatch.setattr(roverlap_net, "make_overlap_windows", ref_windows)
    monkeypatch.setattr(roverlap_net.OverlapNet, "init", ref_init)
    want = roverlap_net.train_overlap_net(ref_corpus, rau, **kw)
    Xr, yr = windows[0]
    X, y = poverlap_net.make_overlap_windows(corpus, au, 16, device="cpu")
    np.testing.assert_array_equal(y, yr)
    # z-scored log-mel: the tones leave bins near silence, where the
    # log(mel + 1e-5) of two f32 FFTs differs by up to ~0.03 z-units
    err = np.abs(X - Xr)
    assert err.max() < 0.05 and np.quantile(err, 0.5) < 1e-4, (
        err.max(), np.quantile(err, 0.5))
    net = poverlap_net.OverlapNet()
    net.load_state_dict(from_flax(net, inits[0]))
    with torch.no_grad():
        got = net(torch.as_tensor(Xr)).numpy()
    np.testing.assert_allclose(
        got, roverlap_net.OverlapNet().apply(inits[0], jnp.asarray(Xr)),
        rtol=0, atol=EMB_TOL)
    # the port trains from the reference's init on the reference's
    # windows: the same batches
    monkeypatch.setattr(poverlap_net, "make_overlap_windows",
                        lambda c, a, n, seed=0, device=None: windows[seed])
    res = poverlap_net.train_overlap_net(corpus, au, device="cpu",
                                         init=inits[0], **kw)
    trained = from_flax(net, to_numpy(want["params"]))
    # the tree both ways: the port's state as a flax tree has the
    # reference's keys and shapes, and loads back
    back = to_flax(net, trained)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        to_numpy(want["params"]))
    same(jax.tree_util.tree_map(np.shape, back),
         jax.tree_util.tree_map(np.shape, to_numpy(want["params"])))
    for k, v in from_flax(net, back).items():
        assert torch.equal(v, trained[k]), k
    for k, v in res["params"].items():
        np.testing.assert_allclose(v.numpy(), trained[k].numpy(), rtol=0,
                                   atol=EMB_TOL, err_msg=k)
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["train_acc"] == want["train_acc"]
    assert res["eval"] == want["eval"]
    screen = poverlap_net.OverlapScreen(au, res["params"], device="cpu")
    rscreen = roverlap_net.OverlapScreen(rau, want["params"])
    for t0 in (3.0, 17.25, 40.5):
        w = dump["wav"][int(t0 * 22050):int((t0 + 0.4) * 22050)]
        assert abs(screen(w) - rscreen(w)) <= EMB_TOL
    assert abs(screen(w[:1000]) - rscreen(w[:1000])) <= EMB_TOL


def test_gnn_train_matches_reference(dump, monkeypatch):
    """5 triplet steps on the dump's window embeddings with spectral
    labels (margin 2: the default 0.3 leaves most steps at zero loss on
    these well-separated embeddings): every step's loss within 1e-5
    relative, the weights within 1e-5."""
    labels = _dump_labels(dump)
    e = dump["emb_plain"]
    ref_losses = []
    jit = jax.jit

    def recording_jit(f):
        g = jit(f)

        def call(*a):
            out = g(*a)
            ref_losses.append(float(out[0]))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    ref = rgnn.GNNClusterer(dim=32, seed=1)
    want = ref.train(e, labels, margin=2.0, steps=5)
    monkeypatch.setattr(jax, "jit", jit)
    port = pgnn.GNNClusterer(dim=32, seed=1)
    got = port.train(e, labels, margin=2.0, steps=5, device="cpu")
    assert len(port.losses) == len(ref_losses) == 5
    assert min(ref_losses) > 0
    np.testing.assert_allclose(port.losses, ref_losses, rtol=1e-5)
    assert got == port.losses[-1] and abs(got - want) <= 1e-5 * abs(want)
    for a, b in zip(port._w, ref._w):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    same(port.cluster_embeddings(e), ref.cluster_embeddings(e))


# ------------------------------------------------------------ controller
def _write_stream(tmp_path):
    wav, truth = two_speaker_wav()
    wp = tmp_path / "two.wav"
    rdata.write_wav(wp, wav, 22050)
    rttm = tmp_path / "truth.rttm"
    rrebuilder.write_rttm(rttm, "two", truth)
    return wp, rttm


@pytest.mark.parametrize("config", ["modularity", "spectral"])
def test_controller_end_to_end_matches_reference(config, tmp_path, names):
    """The 8 s two-speaker stream through both controllers with the tiny
    encoder carried across: the same slices, speakers, overlaps, DER and
    artifact files, byte-equal RTTM and rebuilt wavs, certainties within
    1e-5."""
    wp, truth = _write_stream(tmp_path)
    kw = dict(PROD) if config == "spectral" else {}
    ref_emb, port_emb = embedders()
    outs, dirs = [], []
    for P, emb in ((REF, ref_emb), (PORT, port_emb)):
        names()
        ctl = P.controller.DiarizerController(
            _audio(P), embedder=emb, **kw, **P.dev)
        out = tmp_path / P.name
        res = ctl.diarize_single(str(wp), str(out))
        assert json.loads((out / "diarization_log.json").read_text())[
            "status"] == "ok"
        assert res and res["slices"]
        res["evaluate"] = ctl.evaluate(str(truth), str(out / "two.rttm"))
        outs.append(res)
        dirs.append(out)
    got, want = outs[1], outs[0]
    for k in ("certainty",):
        np.testing.assert_allclose(
            [got[k][c] for c in sorted(got[k])],
            [want[k][c] for c in sorted(want[k])], rtol=0, atol=1e-5)
        got.pop(k), want.pop(k)
    same(got, want)
    files = [_tree(d) for d in dirs]
    assert files[0].keys() == files[1].keys()
    for name in files[0]:
        if name.endswith((".rttm", ".wav", "_intervals.json", ".csv",
                          "speaker_stats.json", "speaker_mapping.json",
                          "transcript.json")):
            assert files[1][name] == files[0][name], name
    assert any(n.startswith("speakers/") and n.endswith(".wav")
               for n in files[0])


def test_main_diarize_single_and_batch(tmp_path):
    """The CLI on the CPU: one wav with --eval and --snapshot, then two
    wavs in batch mode with 2 workers (the same stem in two folders:
    both run)."""
    from ttsx_torch.cli.main import main_diarize
    wp, truth = _write_stream(tmp_path)
    snap = tmp_path / "mem.pkl"
    out = tmp_path / "single"
    assert main_diarize([str(wp), "--output-dir", str(out), "--device",
                         "cpu", "--eval", str(truth), "--snapshot",
                         str(snap)]) == 0
    assert json.loads((out / "diarization_log.json").read_text())[
        "status"] == "ok"
    assert snap.exists() and (out / "diarizer.log").exists()
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "x.wav").write_bytes(wp.read_bytes())
    out = tmp_path / "batch"
    assert main_diarize([str(tmp_path / "a/x.wav"), str(tmp_path / "b/x.wav"),
                         "--output-dir", str(out), "--device", "cpu",
                         "--workers", "2", "--eval", str(truth),
                         "--snapshot", str(snap)]) == 0
    for job in ("x", "x_1"):
        assert json.loads((out / job / "diarization_log.json").read_text())[
            "status"] == "ok", job


# -------------------------------------------------- the two departures
def _recording_controller(P, monkeypatch):
    calls = []

    def fake(self, wav_path, out_dir, **kw):
        calls.append((wav_path, out_dir))
        P.controller.log.info("job %s", wav_path)
        return {"slices": [[0.0, 1.0]], "out": out_dir}

    monkeypatch.setattr(P.controller.DiarizerController, "diarize_single",
                        fake)
    return P.controller.DiarizerController(_audio(P), **P.dev), calls


@pytest.mark.parametrize("workers", [1, 2])
def test_batch_runs_every_input_under_a_unique_id(tmp_path, monkeypatch,
                                                  workers):
    """Departure (a): the reference keys batch jobs by stem, so a/x.wav
    and b/x.wav share one output directory and one result; the port runs
    each under its own id and directory."""
    paths = [str(tmp_path / "a/x.wav"), str(tmp_path / "b/x.wav"),
             str(tmp_path / "c/y.wav")]
    ref, ref_calls = _recording_controller(REF, monkeypatch)
    res = ref.diarize_batch(paths, str(tmp_path / "ref"), workers=workers)
    assert sorted(res) == ["x", "y"]
    assert len({d for _, d in ref_calls}) == 2
    port, calls = _recording_controller(PORT, monkeypatch)
    res = port.diarize_batch(paths, str(tmp_path / "port"), workers=workers)
    assert sorted(res) == ["x", "x_1", "y"]
    assert sorted(calls) == sorted(
        zip(paths, [str(tmp_path / "port" / j) for j in ("x", "x_1", "y")]))
    assert pcontroller.job_ids(["a/x.wav", "b/x.wav", "x_1.wav", "c/x.wav"]
                               ) == ["x", "x_1", "x_1_2", "x_3"]


def test_batch_keeps_one_log_handler(tmp_path, monkeypatch):
    """Departure (b): over diarize_batch calls with different roots the
    reference piles one handler per root on the shared logger, and each
    line goes to every earlier root's log; the port's controller keeps
    one handler it installed, moved to the newest root."""
    def handlers(logger):
        return [h for h in logger.handlers
                if isinstance(h, logging.handlers.RotatingFileHandler)]

    for P, n_want in ((REF, 3), (PORT, 1)):
        logger = P.controller.log
        before = list(logger.handlers)
        ctl, _ = _recording_controller(P, monkeypatch)
        try:
            for root in ("r1", "r2", "r3"):
                ctl.diarize_batch([str(tmp_path / "w.wav")],
                                  str(tmp_path / P.name / root))
            assert len(handlers(logger)) - len(
                [h for h in before if h in handlers(logger)]) == n_want
            for h in logger.handlers:
                h.flush()
            first = (tmp_path / P.name / "r1/diarizer.log").read_text()
            assert first.count("job ") == (3 if P is REF else 1)
        finally:
            for h in list(logger.handlers):
                if h not in before:
                    logger.removeHandler(h)
                    h.close()


# ---------------------------------------------------- the slice's check
def test_production_controller_on_dump_stream(tmp_path):
    """The port's zoo encoder and production controller on the dump's
    whole stream, on the CPU: status ok and the reference's recorded
    DER (strict and 250 ms collar, overlap speakers included), speaker
    count and segment count."""
    from ttsx_torch.zoo import AUDIO, load_diar_encoder
    d = np.load(DUMP, allow_pickle=True)
    truth = [(float(s), float(e), str(k)) for s, e, k in
             zip(d["truth_start"], d["truth_end"], d["truth_spk"])]
    wp = tmp_path / "dialogue_hard.wav"
    rdata.write_wav(wp, d["wav"].astype(np.float32), AUDIO.sample_rate)
    ctl = pcontroller.DiarizerController(
        AUDIO, embedder=load_diar_encoder(device="cpu"), device="cpu",
        **PROD)
    res = ctl.diarize_single(str(wp), str(tmp_path / "out"))
    log_ = json.loads((tmp_path / "out/diarization_log.json").read_text())
    assert log_["status"] == "ok" and res
    hyp = [(s, e, spk) for (s, e), spk in zip(res["slices"],
                                               res["speakers"])]
    hyp += [(s, e, spk) for s, e, sa, sb, _c in res["overlap_speakers"]
            for spk in (sa, sb)]
    der = pmetrics.diarization_error_rate(truth, hyp)
    der_c = pmetrics.diarization_error_rate(truth, hyp, collar=0.25)
    assert (round(der, 5), round(der_c, 5)) == (ZOO_DER, ZOO_DER_COLLAR)
    assert len(set(res["speakers"])) == ZOO_SPEAKERS
    assert len(res["slices"]) == ZOO_SEGMENTS


def test_diarizer_config_round_trip():
    cfg = rcfg.DiarizerConfig(cluster_method="spectral", min_slice_dur=0.8)
    port = pcfg.from_dict(pcfg.DiarizerConfig, rcfg.to_dict(cfg))
    assert pcfg.to_dict(port) == rcfg.to_dict(cfg)
    assert pcfg.to_dict(pcfg.DiarizerConfig()) == rcfg.to_dict(
        rcfg.DiarizerConfig())
    ctl = pcontroller.DiarizerController.from_config(port, device="cpu")
    assert (ctl.min_dur, ctl.cluster_method, ctl.memory.match_threshold) == (
        0.8, "spectral", 0.6)


# ------------------------------------------------------------------ slow
@pytest.mark.slow
def test_zoo_production_controller_equals_reference(tmp_path, names):
    """Both packages' zoo encoders and production controllers on the
    dump's whole stream: the window embeddings within 1e-5, and equal
    segments, partition and DER; the recorded constants are the
    reference's."""
    from ttsx.eval.parity_common import AUDIO as RAUDIO
    from ttsx.zoo import load_diar_encoder as ref_load
    from ttsx_torch.zoo import AUDIO, load_diar_encoder
    d = np.load(DUMP, allow_pickle=True)
    truth = [(float(s), float(e), str(k)) for s, e, k in
             zip(d["truth_start"], d["truth_end"], d["truth_spk"])]
    wp = tmp_path / "dialogue_hard.wav"
    rdata.write_wav(wp, d["wav"].astype(np.float32), AUDIO.sample_rate)
    wins = [tuple(w) for w in d["win_plain"]]
    encs = (ref_load(), load_diar_encoder(device="cpu"))
    wav, _ = rdata.read_wav(str(wp), AUDIO.sample_rate)
    np.testing.assert_allclose(encs[1].extract(wav, wins),
                               encs[0].extract(wav, wins), rtol=0,
                               atol=EMB_TOL)
    outs = []
    for P, au, enc in ((REF, RAUDIO, encs[0]), (PORT, AUDIO, encs[1])):
        names()
        ctl = P.controller.DiarizerController(au, embedder=enc, **PROD,
                                              **P.dev)
        res = ctl.diarize_single(str(wp), str(tmp_path / P.name))
        assert json.loads((tmp_path / P.name / "diarization_log.json"
                           ).read_text())["status"] == "ok" and res
        hyp = [(s, e, spk) for (s, e), spk in zip(res["slices"],
                                                   res["speakers"])]
        hyp += [(s, e, spk) for s, e, sa, sb, _c in res["overlap_speakers"]
                for spk in (sa, sb)]
        outs.append(dict(
            slices=res["slices"], speakers=res["speakers"],
            overlaps=res["overlaps"],
            der=rmetrics.diarization_error_rate(truth, hyp),
            der_collar=rmetrics.diarization_error_rate(truth, hyp,
                                                       collar=0.25)))
    same(outs[1], outs[0])
    assert (round(outs[0]["der"], 5), round(outs[0]["der_collar"], 5)) == (
        ZOO_DER, ZOO_DER_COLLAR)
    assert len(set(outs[0]["speakers"])) == ZOO_SPEAKERS
    assert len(outs[0]["slices"]) == ZOO_SEGMENTS


@pytest.mark.slow
def test_overlap_net_300_steps_matches_reference(monkeypatch):
    """train_overlap_net(ToneCorpus(6 speakers), AUDIO, 300 steps, batch
    32) in both packages from the reference's init on the reference's
    windows: the held-out and training accuracies within two windows,
    both at least 0.9. The weights are not compared: 300 Adam steps on a
    loss that falls to ~0.01 amplify f32 rounding (the two runs' first
    convolution ends 1.8e-2 apart, measured); the first 3 steps are held
    to 1e-5 in test_overlap_net_matches_reference."""
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.zoo import AUDIO
    from ttsx.eval.parity_common import AUDIO as RAUDIO
    windows, inits = {}, []
    make, init = roverlap_net.make_overlap_windows, roverlap_net.OverlapNet.init

    def ref_windows(corpus_, audio, n, seed=0):
        windows[seed] = make(corpus_, audio, n, seed)
        return windows[seed]

    def ref_init(self, *a):
        inits.append(to_numpy(init(self, *a)))
        return inits[-1]

    monkeypatch.setattr(roverlap_net, "make_overlap_windows", ref_windows)
    monkeypatch.setattr(roverlap_net.OverlapNet, "init", ref_init)
    want = roverlap_net.train_overlap_net(
        RToneCorpus(n_speakers=6, audio=RAUDIO), RAUDIO, steps=300,
        batch=32)
    monkeypatch.setattr(poverlap_net, "make_overlap_windows",
                        lambda c, a, n, seed=0, device=None: windows[seed])
    res = poverlap_net.train_overlap_net(
        ToneCorpus(n_speakers=6, audio=AUDIO), AUDIO, steps=300, batch=32,
        device="cpu", init=inits[0])
    assert abs(res["eval"]["acc"] - want["eval"]["acc"]) <= 2 / 256
    assert abs(res["train_acc"] - want["train_acc"]) <= 2 / 512
    assert min(res["eval"]["acc"], want["eval"]["acc"]) >= 0.9
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 300
