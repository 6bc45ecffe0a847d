"""Anomaly detection stage: transcription-hallucination checks + sentiment
swing/outlier detection, with thresholds calibrated from a validation set.

Re-designs modules/anomaly/anomaly.py:14-166: short-text / repetition-ratio /
silent-with-words checks, VADER swing outliers, calibration from
validation_set.json (mean+2std) cached to calibration.json atomically,
emotion entropy + confidence-drift slope into drift_log.json.

A copy of ``ttsx/pipeline/anomaly.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json


def repetition_ratio(text: str) -> float:
    words = text.lower().split()
    if len(words) < 2:
        return 0.0
    counts = Counter(words)
    return 1.0 - len(counts) / len(words)


def label_entropy(labels: List[str]) -> float:
    if not labels:
        return 0.0
    counts = Counter(labels)
    n = len(labels)
    return -sum((c / n) * math.log(c / n + 1e-12) for c in counts.values())


def confidence_slope(confs: List[float]) -> float:
    if len(confs) < 2:
        return 0.0
    x = np.arange(len(confs), dtype=np.float64)
    y = np.asarray(confs, np.float64)
    x = x - x.mean()
    denom = (x ** 2).sum()
    return float((x * (y - y.mean())).sum() / denom) if denom else 0.0


class AnomalyStage(Stage):
    name = "anomaly"

    def __init__(self, min_words: int = 2, rep_thresh: float = 0.6,
                 swing_thresh: float = 1.2):
        self.min_words = min_words
        self.rep_thresh = rep_thresh
        self.swing_thresh = swing_thresh

    def _calibrate(self, context: Dict) -> Dict:
        """mean+2std thresholds from validation_set.json, cached
        (anomaly.py:22-71)."""
        from pathlib import Path
        out_dir = Path(context["output_dir"])
        cal_path = out_dir / "calibration.json"
        cached = read_json(cal_path)
        if cached:
            return cached
        val = read_json(out_dir / "validation_set.json", {"items": []})
        reps = [repetition_ratio(it.get("text", ""))
                for it in val.get("items", [])]
        cal = {
            "rep_thresh": (float(np.mean(reps) + 2 * np.std(reps))
                           if reps else self.rep_thresh),
        }
        write_json_atomic(cal_path, cal)
        return cal

    def run(self, context: Dict) -> Dict:
        cal = self._calibrate(context)
        rep_thresh = cal.get("rep_thresh", self.rep_thresh)
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            t2 = read_json(d / "tier2_tags.json", {"tags": []})["tags"]
            anomalies = []
            compounds = [t.get("scores", {}).get("compound", 0.0)
                         for t in read_json(d / "tier1_tags.json",
                                            {"tags": []})["tags"]]
            for i, tag in enumerate(t2):
                reasons = []
                words = tag["text"].split()
                if 0 < len(words) < self.min_words:
                    reasons.append("short_text")
                if repetition_ratio(tag["text"]) > rep_thresh:
                    reasons.append("repetition")
                if i > 0 and i - 1 < len(compounds) and i < len(compounds):
                    if abs(compounds[i] - compounds[i - 1]) > self.swing_thresh:
                        reasons.append("sentiment_swing")
                if reasons:
                    anomalies.append({"index": i, "reasons": reasons,
                                      "text": tag["text"]})
            # inject into drift_vector.json (anomaly.py behavior)
            drift = read_json(d / "drift_vector.json", {})
            drift["anomalies"] = anomalies
            write_json_atomic(d / "drift_vector.json", drift)
            log = read_json(d / "drift_log.json", {})
            log["emotion_entropy"] = round(
                label_entropy([t["label"] for t in t2]), 4)
            log["confidence_slope"] = round(
                confidence_slope([t["confidence"] for t in t2]), 5)
            write_json_atomic(d / "drift_log.json", log)
            results[spk] = {"n_anomalies": len(anomalies)}
        return {"speakers": results}
