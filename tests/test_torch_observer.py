"""The observer ingestion pipeline of the port (``ttsx_torch.pipeline``)
against the reference (``ttsx.pipeline``) on the CPU.

* Every numpy stage (drift, alignment, tier 1, tier 2, anomaly,
  fingerprint, arc, plot map, dynamic learning, git sync) runs in both
  packages on the same input files: every artifact is equal, but for
  ``job_manifest.json``'s ``timestamp`` (and ``.lock`` files, logs).
* ``ASRService.transcribe`` (the energy VAD) and ``ProsodyExtractStage``
  (f0 / energy and a small ``ProsodyPredictor`` with the reference's
  weights) on a wav longer than one 4,096-frame window.
* One ``ObserverPipeline.run_job`` in each package on the 8 s
  two-speaker stream with the tiny slice encoder carried across and the
  ``ScriptedText`` transcriber: status ``done``, every stage ``ok``, the
  same speakers, every artifact equal, ``prosody_trend.json`` within
  ``TREND_TOL``.
* The port alone: ``main_observer`` (a job, and ``--watch`` ending on
  SIGINT), ``watch``, the trigger and worker, ``ReviewSession``, and
  one log handler per logger over a watcher's jobs.

New speakers are named from ``uuid.uuid4``: a counter here, restarted
for each package.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import subprocess
import threading
import time
import types
import uuid
from logging.handlers import RotatingFileHandler
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_parity_helpers import (Names, init_like, jitted, same,
                                  tiny_encoder, to_numpy, two_speaker_wav)

import ttsx.core.config as rcfg
import ttsx.pipeline as rpipe
import ttsx.pipeline.asr as rasr
import ttsx.pipeline.tiers as rtiers
from ttsx.data.dataset import write_wav
from ttsx.models.prosody import ProsodyPredictor as RProsodyPredictor
from ttsx.pipeline.diarizer.cluster import ReIDMemory as RReIDMemory
from ttsx.pipeline.diarizer.controller import (
    DiarizerController as RController)
from ttsx.pipeline.diarizer.embedding import SliceEmbedder as RSliceEmbedder

import ttsx_torch.core.config as pcfg
import ttsx_torch.pipeline as ppipe
import ttsx_torch.pipeline.asr as pasr
import ttsx_torch.pipeline.tiers as ptiers
from ttsx_torch.pipeline.asr import SCRIPT, ScriptedText
from ttsx_torch.pipeline.diarizer.controller import (
    DiarizerController as PController)
from ttsx_torch.pipeline.diarizer.embedding import (
    SliceEmbedder as PSliceEmbedder)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REF = types.SimpleNamespace(name="ref", pipe=rpipe, asr=rasr, tiers=rtiers,
                            cfg=rcfg, dev={})
PORT = types.SimpleNamespace(name="port", pipe=ppipe, asr=pasr,
                             tiers=ptiers, cfg=pcfg, dev={"device": "cpu"})
PKGS = (REF, PORT)
# prosody_trend.json of the two packages: f0 within one 0.01 rounding step
# (an autocorrelation peak picked in float32 by two FFTs), energy within
# one 1e-5 step, the predictor's f0 / MFCC one step of theirs, its
# utterance scalars within 1e-5 of their scale
TREND_TOL = {"f0": 0.01, "energy": 1e-5, "model_f0": 0.01, "mfcc": 1e-3,
             "speech_rate": 1e-5, "pause_dur": 1e-5}
# the ReID match threshold of the job's diarizer: at the default 0.6 the
# tiny encoder's two clusters on the stream name one speaker
MATCH = 0.9
STAGES = ("DriftStage", "AlignmentStage", "Tier1Stage", "Tier2Stage",
          "AnomalyStage", "FingerprintStage", "ArcStage", "PlotMapStage",
          "DynamicLearningStage", "GitSyncStage")


def artifacts(root: Path) -> dict:
    """{relative path: content} under ``root``: JSON parsed (the
    manifest without its ``timestamp``), other files as bytes; ``.lock``
    files and logs left out."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file() or p.suffix in (".lock", ".log"):
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".json":
            data = json.loads(p.read_text())
            if p.name == "job_manifest.json":
                data.pop("timestamp")
            out[rel] = data
        else:
            out[rel] = p.read_bytes()
    return out


def same_tree(a: Path, b: Path, skip=()):
    got, want = artifacts(b), artifacts(a)
    assert got.keys() == want.keys()
    for k in want:
        if k not in skip:
            same(got[k], want[k], k)


# ---------------------------------------------------- pure-python pieces
@pytest.mark.parametrize("text", SCRIPT + (
    "I hate this terrible awful pain", "the table has four legs",
    "this is not good", "we are not safe.", "hardly a wonderful result",
    "it was good but the end was bad", "no no no never", ""))
def test_sentiment_and_text_heuristics_equal_reference(text):
    """``polarity_scores``, ``vader_vector``, the tier-2 negation,
    contradiction and the services' negation fallback: equal."""
    for fn in ("polarity_scores", "vader_vector"):
        same(getattr(ppipe, fn)(text), getattr(rpipe, fn)(text), fn)
    scores = rpipe.polarity_scores(text)
    same(ptiers.invert_if_negated(text, dict(scores)),
         rtiers.invert_if_negated(text, dict(scores)))
    same(ptiers.contradiction_score(text), rtiers.contradiction_score(text))
    from ttsx.pipeline import services as rservices
    from ttsx_torch.pipeline import services as pservices
    same(pservices.nlp_negation(text), rservices.nlp_negation(text))
    same(pservices.summarize([text, "the end"]),
         rservices.summarize([text, "the end"]))


def test_sentiment_contract():
    """The reference's own sentiment checks, on the port."""
    pos = ppipe.polarity_scores("I love this wonderful amazing day!")
    neg = ppipe.polarity_scores("I hate this terrible awful pain")
    assert pos["compound"] > 0.5 > -0.5 > neg["compound"]
    assert ppipe.polarity_scores("the table has four legs")["neu"] > 0.9
    assert abs(pos["pos"] + pos["neg"] + pos["neu"] - 1.0) < 0.01
    assert (ppipe.polarity_scores("this is good")["compound"] > 0
            > ppipe.polarity_scores("this is not good")["compound"])


def test_emotion_rules_equal_reference():
    """The rule table (ids, labels, keywords), ``GROUP_MAP``, the tier
    thresholds, and ``classify`` on 20,000 random feature vectors."""
    r, p = rpipe.emotion_utils, ppipe.emotion_utils
    same([(x.rule_id, x.label, sorted(x.keywords)) for x in p.RULES],
         [(x.rule_id, x.label, sorted(x.keywords)) for x in r.RULES])
    same(p.GROUP_MAP, r.GROUP_MAP)
    same([p.T1_AUTO, p.T1_MIN, p.T2_AUTO, p.T2_MIN, p.STD_REVIEW],
         [r.T1_AUTO, r.T1_MIN, r.T2_AUTO, r.T2_MIN, r.STD_REVIEW])
    kws = sorted(set().union(*(x.keywords for x in r.RULES)))
    rng = np.random.default_rng(0)
    fired = set()
    for _ in range(20_000):
        s = rng.dirichlet([1, 1, 1])
        kw = dict(pos=s[0], neg=s[1], neu=s[2], pitch=rng.normal(),
                  energy=rng.normal(), speech_rate=rng.normal(),
                  pause=rng.normal(), pitch_var=rng.normal(),
                  energy_var=rng.normal(), keywords=frozenset(
                      rng.choice(kws, size=rng.integers(0, 4))))
        a, b = r.classify(r.Features(**kw)), p.classify(p.Features(**kw))
        assert (a and a.rule_id) == (b and b.rule_id), kw
        fired.add(b and b.label)
    assert fired - {None} == set(p.EMOTION_LABELS)


@pytest.mark.parametrize("series", ["step", "walk", "zeros", "short",
                                    "flip"])
def test_detect_drift_equals_reference(series):
    rng = np.random.default_rng(1)
    x = {"step": np.r_[np.zeros(80), np.full(20, 3.0), np.zeros(100)],
         "walk": np.cumsum(rng.normal(size=300)),
         "zeros": np.zeros(64), "short": rng.normal(size=5),
         "flip": np.tile([2.0, -2.0, 0, 0, 0, 0], 30)}[series]
    same(ppipe.savgol_smooth(x), rpipe.savgol_smooth(x))
    for kw in ({}, {"window": 30}, {"k_sigma": 1.0, "buffer_frames": 1}):
        same(ppipe.detect_drift(x, **kw), rpipe.detect_drift(x, **kw))
    if series == "step":
        ev = ppipe.detect_drift(x, window=30)["events"][0]
        assert 70 <= ev["start"] <= 90


def test_kmeans_and_slice_features_equal_reference():
    rng = np.random.default_rng(2)
    for n, k in ((12, 3), (40, 2), (3, 3), (5, 1)):
        x = rng.uniform(0.3, 1.0, n)
        same(ppipe.kmeans_1d(x, k), rpipe.kmeans_1d(x, k))
    fr = 86.13
    n = int(6.0 * fr)
    f0, en = np.zeros(n), np.full(n, 0.01)
    f0[:int(2 * fr)], en[:int(2 * fr)] = 220.0, 0.2
    f0[int(3 * fr):int(5 * fr)], en[int(3 * fr):int(5 * fr)] = 120.0, 0.05
    tags = [{"start": 0.0, "end": 2.0, "text": "a b c"},
            {"start": 3.0, "end": 5.0, "text": "d"},
            {"start": 7.0, "end": 8.0, "text": "past the end"}]
    for trend in ({"f0": f0.tolist(), "energy": en.tolist()},
                  {"f0": [], "energy": []}):
        rows = ptiers.slice_prosody_features(trend, tags, fr)
        same(rows, rtiers.slice_prosody_features(trend, tags, fr))
    rows = ptiers.slice_prosody_features(
        {"f0": f0.tolist(), "energy": en.tolist()}, tags, fr)
    assert rows[0]["pitch"] > 0 > rows[1]["pitch"]
    for trend in ({}, {"f0": [], "energy": []}, {"f0": [1.0]},
                  {"f0": None, "energy": [1.0]},
                  {"f0": [1.0, 2.0], "energy": [0.1, 0.2]}):
        same(ptiers._trend_usable(trend), rtiers._trend_usable(trend))


def test_pipeline_config_round_trips_with_reference():
    """``PipelineConfig`` and ``TTSXConfig.pipeline``: the reference's
    field names and defaults; a reference dict loads and writes back."""
    assert pcfg.to_dict(pcfg.PipelineConfig()) == rcfg.to_dict(
        rcfg.PipelineConfig())
    ref = rcfg.TTSXConfig(pipeline=rcfg.PipelineConfig(
        drift_window=30,
        diarizer=rcfg.DiarizerConfig(cluster_method="spectral")))
    port = pcfg.from_dict(pcfg.TTSXConfig, rcfg.to_dict(ref))
    assert port.pipeline.drift_window == 30
    assert pcfg.to_dict(port.pipeline) == rcfg.to_dict(ref.pipeline)


def test_service_fallbacks_equal_reference():
    """The services' fallbacks that use a device: the SSL features'
    normalized log-mel within tests/test_torch_dsp.py's 5e-4, the VAD's
    probabilities within 1e-5, the ASR's segments equal."""
    from ttsx.pipeline import services as rservices
    from ttsx_torch.pipeline import services as pservices
    wav, _ = two_speaker_wav()
    wav = wav[:3 * 22050]
    np.testing.assert_allclose(
        pservices.ssl_features(wav[None], 22050, device="cpu"),
        rservices.ssl_features(wav[None], 22050), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(pservices.vad_probs(wav, 22050, "cpu"),
                               rservices.vad_probs(wav, 22050), rtol=0,
                               atol=1e-5)
    same(pservices.asr_transcribe(wav, 22050, "cpu"),
         rservices.asr_transcribe(wav, 22050))


# ----------------------------------------------- the numpy stages' chain
def _write_context(root: Path, case: str) -> dict:
    """The input files of a case under ``root`` (numpy from a seed, the
    same bytes for both packages) and its context."""
    W = rpipe.write_json_atomic
    rng = np.random.default_rng(0)
    if case == "reference_fixture":   # tests/test_pipeline.py's
        spk = {"spkA": None}
        d = root / "emotion_tags" / "spkA"
        f0 = np.concatenate([np.full(60, 120.0), np.full(60, 180.0)])
        f0 += rng.normal(size=120)
        W(d / "prosody_trend.json", {
            "f0": f0.tolist(), "energy": (np.abs(rng.normal(size=120))
                                          * 0.1).tolist(),
            "voiced_ratio": 0.9})
        W(d / "transcript.json", {"segments": [
            {"start": 0.0, "end": 2.0, "text": "I love this wonderful day"},
            {"start": 2.0, "end": 4.0, "text": "this is terrible I hate it"},
            {"start": 4.0, "end": 6.0, "text": "the meeting is at noon"},
            {"start": 6.0, "end": 8.0,
             "text": "I am so happy and excited!"}]})
        return {"job_id": "job1", "output_dir": str(root),
                "speaker_ids": list(spk), "step_times": {}}
    # two speakers, 12 s each at 86.13 frames/s, turns of 0.5-1.5 s
    n = int(12 * 86.13)
    for s, spk in enumerate(("spkA", "spkB")):
        d = root / "emotion_tags" / spk
        t = np.arange(n) / 86.13
        f0 = (120 + 60 * s) * (1 + 0.2 * np.sin(2 * np.pi * 0.3 * t))
        f0 = np.round(f0 + rng.normal(size=n) * 3, 2)
        f0[rng.random(n) < 0.25] = 0.0
        en = np.round(np.abs(0.1 + 0.05 * np.sin(t) + rng.normal(size=n)
                             * 0.02), 5)
        trend = {"f0": f0.tolist(), "energy": en.tolist(),
                 "voiced_ratio": float((f0 > 0).mean())}
        if case == "empty_trend":
            trend = {"f0": [], "energy": []}
        if case != "no_trend":
            W(d / "prosody_trend.json", trend)
        segs, t0 = [], 0.3 * s
        for k in range(10):
            t1 = round(t0 + rng.uniform(0.5, 1.5), 3)
            segs.append({"start": round(t0, 3), "end": t1,
                         "text": SCRIPT[(3 * k + s) % len(SCRIPT)]})
            t0 = t1 + 0.1
        W(d / "transcript.json", {"segments": segs})
    return {"job_id": "job2", "output_dir": str(root),
            "speaker_ids": ["spkA", "spkB"], "step_times": {}}


def _tier2_models(kind):
    """Deterministic stand-ins for the speaker embedder and the emotion
    model of ``Tier2Stage`` (numpy functions of their inputs)."""
    def embed(text):
        return np.cos(np.arange(8) * (1 + len(text) % 5))

    def emotion(vader, pvec):
        return np.abs(np.sin(np.arange(6) * 0.7 + vader.sum() + pvec[:6]
                             .sum()))
    return {"Tier2Stage": dict(embed_fn=embed, emotion_fn=emotion)} if (
        kind == "tier2_models") else {}


def _run_chain(P, ctx, case):
    kw = _tier2_models(case)
    out = {}
    for name in STAGES:
        stage = getattr(P.pipe, name)(**kw.get(name, {}))
        out[name] = stage(ctx)
        if name == "Tier2Stage" and case == "two_speakers":
            sess = P.pipe.ReviewSession(ctx["output_dir"])
            todo = sess.pending("spkA")
            sess.correct("spkA", todo[0]["start"], "Anger", notes="n")
            sess.correct("spkB", 0.3, "Calm")
    return out


@pytest.mark.parametrize("case", ["reference_fixture", "two_speakers",
                                  "no_trend", "empty_trend",
                                  "tier2_models"])
def test_numpy_stage_chain_equals_reference(case, tmp_path):
    """The ten JSON-dataflow stages in order, each package on its own
    copy of the same input files: every stage ``ok`` with the same
    result, every artifact equal (job_manifest.json's ``timestamp``
    aside). ``two_speakers`` also commits review corrections after tier
    2 (dynamic learning's reject tallies); ``no_trend`` and
    ``empty_trend`` take tier 2's drift-delta fallback;
    ``tier2_models`` gives tier 2 an embedder and an emotion model."""
    src = tmp_path / "in"
    ctx = _write_context(src, case)
    results = {}
    for P in PKGS:
        root = tmp_path / P.name
        shutil.copytree(src, root)
        results[P.name] = _run_chain(
            P, dict(ctx, output_dir=str(root), step_times={}), case)
    for name in STAGES:
        r, p = results["ref"][name], results["port"][name]
        for out in (r, p):
            assert out.pop("status") == "ok", (name, out)
            out.pop("wall_time_s")
            out.get("manifest", {}).pop("timestamp", None)
        same(p, r, name)
    same_tree(tmp_path / "ref", tmp_path / "port")
    arc = json.loads((tmp_path / "port/arc_classification.json").read_text())
    end = max(s["end"] for s in arc["segments"])
    assert all(0.0 <= p <= end for p in arc["pivots"])
    t2 = json.loads((tmp_path / "port/emotion_tags/spkA/tier2_tags.json")
                    .read_text())["tags"]
    if case == "tier2_models":
        assert all("model_label" in t for t in t2)
        assert len({t["esr_score"] for t in t2}) > 1


def test_plot_map_pivot_split_equals_reference(tmp_path):
    """tests/test_pipeline.py's pivot case: a pivot inside beat 1 splits
    it into ``1`` and ``1.5``; both packages write the same plot map,
    beat pages and back-annotated drift vector."""
    for P in PKGS:
        root = tmp_path / P.name
        ctx = {"job_id": "job1", "output_dir": str(root),
               "speaker_ids": ["spkA"], "step_times": {}}
        d = root / "emotion_tags" / "spkA"
        tags = [{"start": t, "end": t + 1.0, "text": f"utt {t}",
                 "label": "joy" if t < 5 else "anger", "confidence": 0.9}
                for t in [0.0, 2.0, 4.0, 6.0, 8.0]]
        P.pipe.write_json_atomic(d / "tier2_tags.json", {"tags": tags})
        P.pipe.write_json_atomic(d / "drift_vector.json", {"deltas": []})
        P.pipe.write_json_atomic(root / "arc_classification.json", {
            "segments": [{"start": 0.0, "end": 10.0,
                          "dominant_emotion": "joy", "group": "Positive",
                          "n_tags": 5}], "pivots": [5.0], "pattern": "flat"})
        assert P.pipe.PlotMapStage(beats_per_arc=3)(ctx)["status"] == "ok"
    same_tree(tmp_path / "ref", tmp_path / "port")
    pm = json.loads((tmp_path / "port/plot_map.json").read_text())
    assert pm["n_beats"] == 4
    assert [str(b["beat_id"]) for b in pm["beats"]] == ["0", "1", "1.5", "2"]


def _git_env(monkeypatch):
    for k, v in (("GIT_AUTHOR_NAME", "t"), ("GIT_AUTHOR_EMAIL", "t@x"),
                 ("GIT_COMMITTER_NAME", "t"),
                 ("GIT_COMMITTER_EMAIL", "t@x"),
                 ("GIT_CONFIG_GLOBAL", os.devnull),
                 ("GIT_CONFIG_NOSYSTEM", "1")):
        monkeypatch.setenv(k, v)


def test_git_sync_commits_the_same_files(tmp_path, monkeypatch):
    """``GitSyncStage`` (push off) into a fresh repository per package,
    after the stage chain on the same inputs: the same files committed
    with the same contents (the manifest's timestamp aside), the commit
    recorded in ``last_git_commit.json``."""
    _git_env(monkeypatch)
    src = tmp_path / "in"
    ctx = _write_context(src, "two_speakers")
    trees = {}
    for P in PKGS:
        root, repo = tmp_path / P.name, tmp_path / f"{P.name}_repo"
        shutil.copytree(src, root)
        c = dict(ctx, output_dir=str(root), step_times={})
        _run_chain(P, c, "reference_fixture")
        subprocess.run(["git", "init", "-q", str(repo)], check=True)
        (repo / "README").write_text("jobs\n")
        subprocess.run(["git", "-C", str(repo), "add", "-A"], check=True)
        subprocess.run(["git", "-C", str(repo), "commit", "-qm", "init"],
                       check=True)
        out = P.pipe.GitSyncStage(str(repo))(c)
        assert out["status"] == "ok" and out["pushed"] is False
        head = subprocess.run(["git", "-C", str(repo), "rev-parse", "HEAD"],
                              capture_output=True, text=True).stdout.strip()
        last = json.loads((root / "last_git_commit.json").read_text())
        assert out["commit"] == last["commit"] == head != last["previous"]
        files = subprocess.run(["git", "-C", str(repo), "ls-files"],
                               capture_output=True, text=True,
                               check=True).stdout.split()
        assert "jobs/job2/emotion_tags/spkA/tier2_tags.json" in files
        trees[P.name] = (files, artifacts(repo / "jobs"))
    assert trees["port"][0] == trees["ref"][0]
    same(trees["port"][1], trees["ref"][1])


# ------------------------------------------- the stages that use a device
def _long_wav(seconds: float = 55.0, sr: int = 22050) -> np.ndarray:
    """A voiced wav (harmonics of a wandering f0 under a syllable
    envelope, pauses, a little noise) longer than one 4,096-frame
    window at hop 256 (47.6 s)."""
    rng = np.random.default_rng(4)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 * (1 + 0.15 * np.sin(2 * np.pi * 0.2 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(h * phase) / h for h in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * 1.7 * t), 0, None) * (
        np.sin(2 * np.pi * 0.05 * t) > -0.6)
    return (0.3 * env * voice + 0.003 * rng.standard_normal(len(t))
            ).astype(np.float32)


def _small_prosody():
    """(port config, reference config, the reference's weights as a
    numpy tree): 2 non-causal S4 layers of width 32, 4 norm groups."""
    kw = dict(cond_dim=32, n_layers=2)
    s4 = dict(heads=2, norm_groups=4, causal=False, dropout=0.0)
    rc = rcfg.ProsodyConfig(audio=rcfg.AudioConfig(mel_normalize=False),
                            s4=rcfg.S4Config(**s4), **kw)
    pc = pcfg.ProsodyConfig(audio=pcfg.AudioConfig(mel_normalize=False),
                            s4=pcfg.S4Config(**s4), **kw)
    tree = init_like(RProsodyPredictor(rc), np.zeros((1, 64, 80),
                                                     np.float32),
                     seed=6, scale=0.2)
    return pc, rc, to_numpy(tree)


def ref_prosody_stage(cfg, tree):
    """The reference's prosody stage with its predictor's apply jitted
    (the same function, compiled once per window shape; eager dispatch
    compiles op by op)."""
    stage = rasr.ProsodyExtractStage(cfg, tree)
    stage._predictor = types.SimpleNamespace(
        apply=jax.jit(RProsodyPredictor(cfg).apply))
    return stage


def _trend_close(got: dict, want: dict):
    """prosody_trend.json of the port against the reference's: equal
    keys and lengths, each series within ``TREND_TOL``; returns the
    largest difference of each."""
    assert got.keys() == want.keys()
    errs = {}
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, k
        errs[k] = float(np.abs(g - w).max()) if g.size else 0.0
        assert errs[k] <= TREND_TOL.get(k, 0.0) + 1e-9, (k, errs[k])
    return errs


def test_asr_and_prosody_extract_equal_reference(tmp_path):
    """A 55 s wav (two 4,096-frame windows): the energy-VAD segments of
    ``ASRService.transcribe`` equal; ``ProsodyExtractStage`` with a small
    predictor carried across writes the same ``prosody_trend.json``
    within ``TREND_TOL``; the transcription stage's transcript equal."""
    wav = _long_wav()
    pc, rc, tree = _small_prosody()
    segs = [P.asr.ASRService(audio=P.cfg.AudioConfig(), **P.dev
                             ).transcribe(wav, 22050) for P in PKGS]
    same(segs[1], segs[0])
    assert len(segs[1]["segments"]) >= 3
    trends = []
    for P, cfg in ((REF, rc), (PORT, pc)):
        root = tmp_path / P.name
        (root / "speakers").mkdir(parents=True)
        write_wav(root / "speakers" / "spk.wav", wav, 22050)
        ctx = {"output_dir": str(root), "speaker_ids": ["spk"]}
        stage = (ref_prosody_stage(cfg, tree) if P is REF else
                 P.asr.ProsodyExtractStage(cfg, tree, **P.dev))
        out = stage(ctx)
        assert out["status"] == "ok", out
        asr = P.asr.ASRService(audio=P.cfg.AudioConfig(), **P.dev)
        assert P.asr.TranscriptionStage(asr)(ctx)["status"] == "ok"
        trends.append(json.loads((root / "emotion_tags/spk/"
                                  "prosody_trend.json").read_text()))
    assert len(trends[1]["f0"]) > 4096
    assert len(trends[1]["model_f0"]) == 4096
    print(json.dumps({"trend_max_abs_diff": _trend_close(*trends[::-1])}))
    same_tree(tmp_path / "ref", tmp_path / "port",
              skip=("emotion_tags/spk/prosody_trend.json",))


def test_prosody_stage_takes_the_predictors_config():
    """The port's pipeline hands ``prosody_cfg`` to its prosody stage (a
    ``ProsodyPredictor`` brings its own); the reference's builds
    ``ProsodyConfig()``, whose 8 norm groups compute something else
    from the same weights than the 4 the zoo's predictor has."""
    from ttsx_torch.models.prosody import ProsodyPredictor
    from ttsx_torch.weights import load_flax
    pc, _, tree = _small_prosody()
    pipe = ppipe.ObserverPipeline(prosody_params=tree, prosody_cfg=pc,
                                  device="cpu")
    assert pipe.stages[0].cfg == pc
    model = load_flax(ProsodyPredictor(pc), tree)
    assert ppipe.ProsodyExtractStage(params=model, device="cpu").cfg is pc
    mel = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 64, 80)).astype(np.float32))
    eight = load_flax(ProsodyPredictor(pcfg.ProsodyConfig(
        audio=pc.audio, cond_dim=32, n_layers=2, s4=pcfg.S4Config(
            heads=2, norm_groups=8, causal=False))), tree)
    with torch.no_grad():
        a, b = model.eval()(mel)["f0"], eight.eval()(mel)["f0"]
    assert float((a - b).abs().max()) > 1e-3


# ------------------------------------------------------ the job end to end
@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One ``run_job`` of each package on the 8 s two-speaker stream: the
    tiny slice encoder and a small prosody predictor carried across, the
    ``ScriptedText`` transcriber over each package's own energy VAD.
    Returns {package: (summary, output directory)}."""
    root = tmp_path_factory.mktemp("jobs")
    wav, _ = two_speaker_wav()
    wp = root / "two.wav"
    write_wav(wp, wav, 22050)
    kw, enc = tiny_encoder()
    pc, rc, tree = _small_prosody()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for P in PKGS:
            mp.setattr(uuid, "uuid4", Names())
            au = P.cfg.AudioConfig()
            asr = P.asr.ASRService(transcribe_fn=ScriptedText(
                P.asr.ASRService(audio=au, **P.dev)), audio=au, **P.dev)
            if P is REF:
                ctl = RController(au, embedder=jitted(RSliceEmbedder(
                    au, rcfg.RefEncConfig(**kw), params=enc)),
                    memory=RReIDMemory(match_threshold=MATCH))
                pipe = rpipe.ObserverPipeline(au, ctl, asr)
                pipe.stages[0] = ref_prosody_stage(rc, tree)
            else:
                ctl = PController(au, embedder=PSliceEmbedder(
                    au, pcfg.RefEncConfig(**kw), params=enc, device="cpu"),
                    memory=ppipe.ReIDMemory(match_threshold=MATCH),
                    device="cpu")
                pipe = ppipe.ObserverPipeline(au, ctl, asr,
                                              prosody_params=tree,
                                              prosody_cfg=pc, device="cpu")
            d = root / P.name
            out[P.name] = (pipe.run_job(str(wp), str(d)), d)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_job_is_done_with_every_stage_ok(jobs, pkg):
    summary, d = jobs[pkg]
    assert summary["status"] == "done", summary
    assert summary["stages"] and set(summary["stages"].values()) == {"ok"}
    assert len(summary["speakers"]) == 2
    saved = json.loads((d / "job_summary.json").read_text())
    assert saved["status"] == "done" and (d / "observer_report.html").exists()


def test_job_summary_and_speakers_equal_reference(jobs):
    (r, _), (p, d) = jobs["ref"], jobs["port"]
    for k in ("job_id", "status", "speakers", "stages"):
        same(p[k], r[k], k)
    assert p["step_times"].keys() == r["step_times"].keys()
    res = p["resources"]
    assert len(res) == len(p["stages"]) + 1
    assert all("device_bytes_in_use" not in x for x in res)   # the CPU
    for spk in p["speakers"]:
        t = json.loads((d / f"emotion_tags/{spk}/transcript.json")
                       .read_text())["segments"]
        assert t and all(s["text"] in SCRIPT for s in t)


def test_job_artifacts_equal_reference(jobs):
    """Every artifact of the two jobs: ``prosody_trend.json`` within
    ``TREND_TOL``, the diarizer's mean certainty within 1e-5 (the slice
    embeddings' tolerance), every other file equal (step times, the
    resource snapshots and the diarizer's float arrays aside: those are
    held in tests/test_torch_diarizer.py). Measured: every trend value
    and every downstream file equal, the certainty 3.0e-8 apart."""
    (_, rd), (_, pd) = jobs["ref"], jobs["port"]
    got, want = artifacts(pd), artifacts(rd)
    assert got.keys() == want.keys()
    errs = {}
    for k in want:
        if k.endswith("prosody_trend.json"):
            errs[k] = _trend_close(got[k], want[k])
        elif k.endswith((".npy", "step_times.json")):
            continue
        elif k == "job_summary.json":
            got[k].pop("resources")
            for s in (got[k], want[k]):
                s.pop("step_times")
            same(got[k], want[k], k)
        elif k == "diarization_log.json":   # mean_certainty: embeddings
            errs[k] = abs(got[k].pop("mean_certainty")
                          - want[k].pop("mean_certainty"))
            assert errs[k] <= 1e-5
            same(got[k], want[k], k)
        elif k.endswith(".json"):
            same(got[k], want[k], k)
        else:
            assert got[k] == want[k], k
    print(json.dumps({"max_abs_diff": errs}))


# ------------------------------------------------------ the port alone
def _handlers(name):
    return [h for h in logging.getLogger(name).handlers
            if isinstance(h, RotatingFileHandler)]


@pytest.fixture
def signals():
    """Put SIGINT's and SIGTERM's handlers back after the test (``watch``
    replaces them)."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                               signal.SIGTERM)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.fixture
def loggers():
    """Remove the handlers a test adds to the pipeline's loggers."""
    names = ("ttsx_torch.pipeline", "ttsx_torch.plot_map")
    before = {n: list(logging.getLogger(n).handlers) for n in names}
    yield
    for n, hs in before.items():
        lg = logging.getLogger(n)
        for h in list(lg.handlers):
            if h not in hs:
                lg.removeHandler(h)
                h.close()


def _small_job(path: Path):
    wav, _ = two_speaker_wav()
    write_wav(path, wav[:int(4.5 * 22050)], 22050)
    return path


def test_main_observer_job_on_the_cpu(tmp_path, capsys, loggers):
    """``main_observer --job --device cpu`` (the default pipeline: an
    untrained slice encoder, the energy-VAD transcriber): rc 0, a
    ``done`` summary with every stage ``ok`` and speakers."""
    from ttsx_torch.cli.main import main_observer
    wav = _small_job(tmp_path / "job.wav")
    rc = main_observer(["--device", "cpu", "--job", str(wav),
                        "--output-dir", str(tmp_path / "out"),
                        "--config", "unused.yaml"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary == json.loads((tmp_path / "out/job_summary.json")
                                 .read_text())
    assert summary["status"] == "done" and summary["speakers"]
    assert set(summary["stages"].values()) == {"ok"}


def _wait_for(q, jobs, deadline_s=60.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline and any(
            q.get_status(j) not in ("done", "partial-failure", "failed")
            for j in jobs):
        time.sleep(0.05)
    return [q.get_status(j) for j in jobs]


def test_watch_runs_two_jobs_with_one_log_handler(tmp_path, signals,
                                                  loggers):
    """``watch`` on a directory (``poll_s`` 0.05): two ``<name>.wav.ready``
    markers become two ``done`` jobs under the output root. The
    pipeline's and the plot-map stage's loggers each keep one rotating
    handler, at the second job's directory; the first job's log holds
    none of the second's lines (the reference adds a handler per job and
    copies each line into every earlier job's log)."""
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    before = {n: len(_handlers(n)) for n in ("ttsx_torch.pipeline",
                                             "ttsx_torch.plot_map")}
    watcher, worker, q = ppipe.watch(str(inbox), str(tmp_path / "out"),
                                     device="cpu", poll_s=0.05)
    try:
        for name in ("a", "b"):
            _small_job(inbox / f"{name}.wav")
            (inbox / f"{name}.wav.ready").write_text("")
            assert _wait_for(q, [name]) == ["done"]
    finally:
        watcher.stop()
        worker.stop()
    for name in ("a", "b"):
        s = json.loads((tmp_path / f"out/{name}/job_summary.json")
                       .read_text())
        assert s["status"] == "done" and s["speakers"], s
    for n, k in before.items():
        hs = _handlers(n)
        assert len(hs) == k + 1, n
        assert Path(hs[-1].baseFilename).parent == tmp_path / "out/b"
    logging.getLogger("ttsx_torch.pipeline").warning("after job b")
    for h in _handlers("ttsx_torch.pipeline"):
        h.flush()
    assert "after job b" in (tmp_path / "out/b/pipeline.log").read_text()
    assert "after job b" not in (tmp_path / "out/a/pipeline.log").read_text()


def test_trigger_watcher_and_worker(tmp_path):
    """tests/test_pipeline.py's trigger case on the port: a marker becomes
    one job, processed once, its status ``done``."""
    q = ppipe.JobQueue()
    done = []

    def process(job):
        done.append(job["job_id"])
        return {"status": "ok"}

    watcher = ppipe.TriggerWatcher(str(tmp_path), q, poll_s=0.05)
    worker = ppipe.Worker(q, process)
    watcher.start()
    worker.start()
    try:
        (tmp_path / "utt1.wav").write_bytes(b"")
        (tmp_path / "utt1.wav.ready").write_text("")
        assert _wait_for(q, ["utt1"], 5.0) == ["done"]
    finally:
        watcher.stop()
        worker.stop()
    assert done == ["utt1"] and watcher.wait(0)


def test_main_observer_watch_returns_on_sigint(tmp_path, signals, loggers):
    """``main_observer --watch`` returns 0 once SIGINT stops the watcher
    (the reference's loop waits for a ``KeyboardInterrupt`` that its own
    handler keeps from coming, and never returns)."""
    from ttsx_torch.cli.main import main_observer
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    default = signal.getsignal(signal.SIGINT)

    def interrupt():
        """SIGINT once ``watch`` has put its handler in place."""
        deadline = time.time() + 60
        while signal.getsignal(signal.SIGINT) is default:
            if time.time() > deadline:
                return
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGINT)

    sender = threading.Thread(target=interrupt, daemon=True)
    sender.start()
    rc = main_observer(["--device", "cpu", "--watch", str(inbox),
                        "--output-dir", str(tmp_path / "out")])
    sender.join()
    assert rc == 0


def test_review_session(tmp_path):
    """tests/test_pipeline.py's review case on the port, its report and
    corrections equal to the reference's on the same tags."""
    ctx = _write_context(tmp_path / "in", "reference_fixture")
    htmls = []
    for P in PKGS:
        root = tmp_path / P.name
        shutil.copytree(tmp_path / "in", root)
        c = dict(ctx, output_dir=str(root))
        for name in ("DriftStage", "Tier1Stage", "Tier2Stage"):
            getattr(P.pipe, name)()(c)
        sess = P.pipe.ReviewSession(str(root))
        assert sess.speakers() == ["spkA"]
        sess.correct("spkA", 0.0, "Happiness", notes="clearly joyful")
        with pytest.raises(ValueError):
            sess.correct("spkA", 0.0, "not-an-emotion")
        htmls.append(sess.html_report(str(root / "report.html")))
    assert htmls[1] == htmls[0] and "spkA" in htmls[1]
    rules = json.loads((tmp_path / "port/learned_rules.json").read_text())
    assert rules["spkA"]["0.0"]["label"] == "Happiness"
    same_tree(tmp_path / "ref", tmp_path / "port")
