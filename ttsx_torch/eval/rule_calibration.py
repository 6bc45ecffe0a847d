"""Emotion-rule accuracy and tier-2 confidence calibration on labelled
data (``ttsx/eval/rule_calibration.py``), on the port's
``pipeline/{emotion_utils,sentiment,tiers,contracts}.py``; numpy on the
host, no device.

1. ``rule_stability``: per-rule label / group retention under prosody
   noise. Features rejection-sampled inside each rule's acceptance region
   (``classify`` is first-match) get Gaussian noise on their continuous
   dimensions and are classified again.
2. ``tier_accuracy``: Tier1 + Tier2 group accuracy on synthetic labelled
   transcripts (texts from the sentiment lexicon with known polarity, a
   negation flipping the truth) run through the stages by their JSON
   files; accuracy per status, the 10-bin expected calibration error of
   the tier-2 confidence, and the binned confidence -> accuracy map
   written as ``learned_confidences.json`` in ``work_dir``.

    python -m ttsx_torch.eval.rule_calibration [--out FILE]

writes FILE, by default ``eval_results_torch/rule_calibration.json``
under the working directory (the reference's default,
``eval_results/rule_calibration.json``, is the reference's own record).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ttsx_torch.pipeline import emotion_utils as EU
from ttsx_torch.pipeline.sentiment import LEXICON, polarity_scores

DEFAULT_OUT = "eval_results_torch/rule_calibration.json"
_PROSODY_DIMS = ("pitch", "energy", "speech_rate", "pause", "pitch_var",
                 "energy_var")
# union of every keyword mentioned by a rule — derived from the Rule
# data, so rule-keyword edits can never desynchronize the harness
_WORDS = sorted(set().union(*(r.keywords for r in EU.RULES)))


def _sample_features(rng: np.random.Generator) -> EU.Features:
    """Prior over the feature space: sentiment simplex + N(0,1) prosody
    z-scores + 0-2 keywords."""
    sent = rng.dirichlet((1.0, 1.0, 1.5))
    kws = frozenset(rng.choice(_WORDS, size=int(rng.integers(0, 3)),
                               replace=False).tolist())
    z = rng.normal(0.0, 1.0, len(_PROSODY_DIMS))
    return EU.Features(pos=float(sent[0]), neg=float(sent[1]),
                       neu=float(sent[2]), keywords=kws,
                       **dict(zip(_PROSODY_DIMS, map(float, z))))


def _perturb(f: EU.Features, sigma: float,
             rng: np.random.Generator) -> EU.Features:
    d = f._asdict()
    for k in _PROSODY_DIMS:
        d[k] = float(d[k] + rng.normal(0.0, sigma))
    s = np.clip([d["pos"], d["neg"], d["neu"]]
                + rng.normal(0.0, sigma * 0.15, 3), 0.0, None)
    s = s / max(s.sum(), 1e-9)
    d["pos"], d["neg"], d["neu"] = map(float, s)
    return EU.Features(**d)


def rule_stability(samples_per_rule: int = 200,
                   sigmas: Tuple[float, ...] = (0.1, 0.25, 0.5),
                   max_draws: int = 200_000, seed: int = 0) -> Dict:
    """Per-rule classification retention under feature noise."""
    rng = np.random.default_rng(seed)
    pools: Dict[str, List[EU.Features]] = {r.rule_id: [] for r in EU.RULES}
    want = {r.rule_id: samples_per_rule for r in EU.RULES}
    rules_by_id = {r.rule_id: r for r in EU.RULES}
    for _ in range(max_draws):
        if not any(len(pools[k]) < want[k] for k in pools):
            break
        f = _sample_features(rng)
        hit = EU.classify(f)  # first-match = the label the pipeline emits
        if hit is not None and len(pools[hit.rule_id]) < want[hit.rule_id]:
            pools[hit.rule_id].append(f)
    per_rule: Dict[str, Dict] = {}
    for rid, feats in pools.items():
        rule = rules_by_id[rid]
        if not feats:
            per_rule[rid] = {"label": rule.label, "n": 0}
            continue
        row = {"label": rule.label, "n": len(feats)}
        for sigma in sigmas:
            keep_label = keep_group = 0
            for f in feats:
                got = EU.classify(_perturb(f, sigma, rng))
                if got is None:
                    continue  # fell back to the tier-1 base tag
                keep_label += got.label == rule.label
                keep_group += (EU.GROUP_MAP[got.label]
                               == EU.GROUP_MAP[rule.label])
            row[f"label_retention@{sigma}"] = keep_label / len(feats)
            row[f"group_retention@{sigma}"] = keep_group / len(feats)
        per_rule[rid] = row
    reached = [r for r in per_rule.values() if r["n"] > 0]
    agg = {f"mean_group_retention@{s}":
           float(np.mean([r[f"group_retention@{s}"] for r in reached]))
           for s in sigmas}
    agg["rules_reachable"] = len(reached)
    return {"per_rule": per_rule, "aggregate": agg}


# ---------------------------------------------------------------------------
# end-to-end tier1+tier2 on labeled synthetic transcripts
# ---------------------------------------------------------------------------
_FILLER = ("the", "meeting", "ran", "over", "and", "then", "we", "walked",
           "back", "to", "the", "office", "before", "it", "started",
           "raining", "again", "on", "tuesday")

# prosody z-score profiles a speaker would produce for each group (planted
# with margin so the realized global z-scores stay on the right side of the
# rule thresholds): (pitch_z, energy_z, per-frame f0 jitter Hz)
_PROFILES = {"Positive": (0.4, 1.5, 4.0),
             "Negative": (-1.5, -0.4, 3.0),
             "Neutral": (0.0, 0.0, 2.0)}


def _make_transcript(n: int, seed: int) -> List[Dict]:
    """Labeled segments: ground-truth group from the planted valence words
    (flipped when a negation precedes them)."""
    rng = np.random.default_rng(seed)
    pos_words = [w for w, v in LEXICON.items() if v >= 1.8]
    neg_words = [w for w, v in LEXICON.items()
                 if v <= -1.8 and w not in ("no", "never")]
    weak_pos = [w for w, v in LEXICON.items() if 0.7 <= v < 1.8]
    weak_neg = [w for w, v in LEXICON.items() if -1.8 < v <= -0.7]
    segs = []
    for i in range(n):
        group = ("Positive", "Negative", "Neutral")[int(rng.integers(0, 3))]
        words = list(rng.choice(_FILLER, size=int(rng.integers(2, 5))))
        truth = group
        hard = rng.random() < 0.15  # weak/ambiguous sentiment
        if group != "Neutral":
            if hard:  # one weak word buried in fillers
                bank = weak_pos if group == "Positive" else weak_neg
                words += list(rng.choice(_FILLER, size=4))
                planted = [str(rng.choice(bank))]
            else:
                bank = pos_words if group == "Positive" else neg_words
                planted = [str(rng.choice(bank))
                           for _ in range(int(rng.integers(3, 5)))]
            if rng.random() < 0.25:  # negated -> ground truth flips
                planted = ["not " + w for w in planted]
                truth = "Negative" if group == "Positive" else "Positive"
            for w in planted:
                words.insert(int(rng.integers(0, len(words) + 1)), w)
        text = " ".join(words)
        # 10%: prosody contradicts the words (flat/mismatched affect) —
        # the stage should still recover the group from the text
        pros_truth = truth
        if rng.random() < 0.10:
            pros_truth = ("Positive", "Negative", "Neutral")[
                int(rng.integers(0, 3))]
        segs.append({"start": 2.0 * i, "end": 2.0 * i + 1.8,
                     "text": text, "truth": truth,
                     "pros_truth": pros_truth})
    return segs


def _plant_prosody(segs: List[Dict], frame_rate: float,
                   seed: int) -> Dict:
    """prosody_trend.json frame series consistent with each segment's
    truth group (the speaker *sounds like* what they say)."""
    rng = np.random.default_rng(seed + 1)
    n_frames = int((segs[-1]["end"] + 0.5) * frame_rate) if segs else 0
    f0 = np.zeros(n_frames)           # 0 = unvoiced (the gaps)
    energy = np.full(n_frames, 0.01) + rng.normal(0, 0.001, n_frames)
    for s in segs:
        si = int(s["start"] * frame_rate)
        ei = min(int(s["end"] * frame_rate), n_frames)
        zp, ze, jit = _PROFILES[s.get("pros_truth", s["truth"])]
        f0[si:ei] = 170.0 + 35.0 * zp + rng.normal(0, jit, ei - si)
        energy[si:ei] = np.maximum(
            0.12 + 0.04 * ze + rng.normal(0, 0.004, ei - si), 1e-4)
    return {"f0": f0.round(2).tolist(), "energy": energy.round(5).tolist(),
            "voiced_ratio": float((f0 > 0).mean())}


def tier_accuracy(n_segments: int = 600, seed: int = 0,
                  work_dir: str | None = None) -> Dict:
    import tempfile
    from ttsx_torch.pipeline.contracts import (read_json, speaker_dir,
                                               write_json_atomic)
    from ttsx_torch.pipeline.tiers import Tier1Stage, Tier2Stage

    out = Path(work_dir or tempfile.mkdtemp())
    ctx = {"job_id": "ruleCal", "output_dir": str(out),
           "speaker_ids": ["spk0"]}
    segs = _make_transcript(n_segments, seed)
    d = speaker_dir(ctx, "spk0")
    write_json_atomic(d / "transcript.json", {"segments": [
        {k: s[k] for k in ("start", "end", "text")} for s in segs]})
    t2 = Tier2Stage()
    write_json_atomic(d / "prosody_trend.json",
                      _plant_prosody(segs, t2.frame_rate, seed))
    Tier1Stage().run(ctx)
    t2.run(ctx)
    tags = read_json(d / "tier2_tags.json", {"tags": []})["tags"]
    assert len(tags) == len(segs)

    correct = np.array([t["group"] == s["truth"]
                        for t, s in zip(tags, segs)])
    conf = np.array([t["confidence"] for t in tags])
    status = [t["status"] for t in tags]
    by_status = {}
    for st in ("auto-accept", "needs-review", "force-manual"):
        m = np.array([x == st for x in status])
        if m.any():
            by_status[st] = {"n": int(m.sum()),
                             "accuracy": float(correct[m].mean())}
    # 10-bin ECE + the binned confidence->accuracy recalibration map
    edges = np.linspace(0.0, 1.0, 11)
    ece, bins = 0.0, {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (conf >= lo) & (conf < hi if hi < 1.0 else conf <= hi)
        if m.any():
            acc = float(correct[m].mean())
            ece += (m.sum() / len(conf)) * abs(acc - float(conf[m].mean()))
            bins[f"{lo:.1f}-{hi:.1f}"] = {"n": int(m.sum()), "accuracy": acc}
    # learned_confidences.json-shaped artifact (dynamic_learning contract)
    recal = {rid: {"confidence": b["accuracy"], "n": b["n"]}
             for rid, b in bins.items()}
    write_json_atomic(out / "learned_confidences.json",
                      {"bins": recal, "ece": float(ece)})
    return {"n": len(segs), "group_accuracy": float(correct.mean()),
            "ece": float(ece), "by_status": by_status, "bins": bins}


def main(argv=None):
    p = argparse.ArgumentParser("ttsx-torch-rule-calibration")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--segments", type=int, default=600)
    args = p.parse_args(argv)
    res = {"rule_stability": rule_stability(args.samples),
           "tier_accuracy": tier_accuracy(args.segments)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"group_accuracy":
                      res["tier_accuracy"]["group_accuracy"],
                      "ece": res["tier_accuracy"]["ece"],
                      **res["rule_stability"]["aggregate"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
