"""Fingerprint + narrative-arc stages.

Re-designs modules/fingerprint/fingerprint.py:14-60 (per-speaker summary:
dominant tags, avg confidence, label entropy, avg |drift|, drift slope)
and modules/arc/arc.py:39-144 (job-level narrative arc: KMeans pivots over
confidences, dominant-emotion segments, named-arc pattern table).

A copy of ``ttsx/pipeline/fingerprint.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json
from ttsx_torch.pipeline.anomaly import label_entropy, confidence_slope
from ttsx_torch.pipeline.emotion_utils import GROUP_MAP


class FingerprintStage(Stage):
    name = "fingerprint"

    def run(self, context: Dict) -> Dict:
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            t2 = read_json(d / "tier2_tags.json", {"tags": []})["tags"]
            drift = read_json(d / "drift_vector.json", {})
            deltas = np.asarray(drift.get("deltas", []), np.float64)
            labels = [t["label"] for t in t2]
            confs = [t["confidence"] for t in t2]
            fp = {
                "dominant_tags": [l for l, _ in
                                  Counter(labels).most_common(3)],
                "avg_confidence": round(float(np.mean(confs)), 4)
                if confs else 0.0,
                "label_entropy": round(label_entropy(labels), 4),
                "avg_abs_drift": round(float(np.abs(deltas).mean()), 5)
                if len(deltas) else 0.0,
                "drift_slope": round(confidence_slope(
                    deltas.tolist() if len(deltas) else []), 6),
                "n_tags": len(t2),
            }
            write_json_atomic(d / "fingerprint.json", fp)
            results[spk] = fp
        return {"speakers": results}


def kmeans_1d(x: np.ndarray, k: int, iters: int = 25,
              seed: int = 0) -> np.ndarray:
    """Tiny 1-D k-means (the reference's sklearn KMeans over confidences)."""
    rng = np.random.default_rng(seed)
    centers = np.sort(rng.choice(x, size=min(k, len(x)), replace=False))
    for _ in range(iters):
        assign = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)
        new = np.array([x[assign == i].mean() if (assign == i).any()
                        else centers[i] for i in range(len(centers))])
        if np.allclose(new, centers):
            break
        centers = new
    return np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)


# named-arc pattern table (arc.py: `hope->betrayal->resignation` etc.)
ARC_PATTERNS = {
    ("Positive", "Negative", "Negative"): "hope->betrayal->resignation",
    ("Positive", "Negative", "Positive"): "fall->redemption",
    ("Negative", "Positive", "Positive"): "rags-to-riches",
    ("Negative", "Positive", "Negative"): "false-dawn",
    ("Positive", "Positive", "Positive"): "steady-triumph",
    ("Negative", "Negative", "Negative"): "tragedy",
    ("Neutral", "Negative", "Positive"): "trial-and-victory",
    ("Positive", "Neutral", "Negative"): "slow-unraveling",
}


class ArcStage(Stage):
    name = "arc"

    def __init__(self, seconds_per_cluster: float = 300.0, max_k: int = 3):
        self.seconds_per_cluster = seconds_per_cluster
        self.max_k = max_k

    def run(self, context: Dict) -> Dict:
        all_tags: List[Dict] = []
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            for t in read_json(d / "tier2_tags.json", {"tags": []})["tags"]:
                all_tags.append({**t, "speaker": spk})
        all_tags.sort(key=lambda t: t.get("start", 0.0))
        if not all_tags:
            out = {"segments": [], "pivots": [], "pattern": "empty"}
            write_json_atomic(
                f"{context['output_dir']}/arc_classification.json", out)
            return out

        duration = max(t.get("end", 0.0) for t in all_tags)
        k = int(np.clip(duration / self.seconds_per_cluster, 1, self.max_k))
        confs = np.asarray([t["confidence"] for t in all_tags])
        assign = kmeans_1d(confs, k) if len(confs) >= k else np.zeros(
            len(confs), int)
        pivot_idx = [i for i in range(1, len(assign))
                     if assign[i] != assign[i - 1]]
        # artifact contract: pivots are TIMES (the pivot tag's start),
        # not indices — reference arc.py:113; plot_map consumes them to
        # split beats at pivot boundaries
        pivots = [float(all_tags[i].get("start", 0.0)) for i in pivot_idx]

        # dominant-emotion segments between pivots
        seg_bounds = [0] + pivot_idx + [len(all_tags)]
        segments = []
        for a, b in zip(seg_bounds[:-1], seg_bounds[1:]):
            seg_tags = all_tags[a:b]
            if not seg_tags:
                continue
            dom = Counter(t["label"] for t in seg_tags).most_common(1)[0][0]
            segments.append({
                "start": seg_tags[0].get("start", 0.0),
                "end": seg_tags[-1].get("end", 0.0),
                "dominant_emotion": dom,
                "group": GROUP_MAP.get(dom, "Neutral"),
                "n_tags": len(seg_tags),
            })

        groups = tuple(s["group"] for s in segments[:3])
        while len(groups) < 3 and groups:
            groups = groups + (groups[-1],)
        pattern = ARC_PATTERNS.get(groups, "->".join(g.lower()
                                                     for g in groups))
        out = {"segments": segments, "pivots": pivots, "pattern": pattern,
               "k": int(k)}
        write_json_atomic(
            f"{context['output_dir']}/arc_classification.json", out)
        return out
