"""Alignment stage: composite slice ranking.

Re-designs modules/alignment/alignment.py:12-72 — weighted
silence/prosody/polarity/vad scores per slice -> alignment.json
(ranked_slices, scores).

A copy of ``ttsx/pipeline/alignment.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json


class AlignmentStage(Stage):
    name = "alignment"

    def __init__(self, w_silence=0.25, w_prosody=0.35, w_polarity=0.2,
                 w_vad=0.2):
        self.w = (w_silence, w_prosody, w_polarity, w_vad)

    def run(self, context: Dict) -> Dict:
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            drift = read_json(d / "drift_vector.json", {})
            slices = drift.get("slices", [])
            deltas = np.asarray(drift.get("deltas", []), np.float64)
            events = drift.get("events", [])
            scores = []
            for a, b in slices:
                seg = deltas[a:b] if len(deltas) else np.zeros(1)
                prosody_score = float(np.clip(np.abs(seg).mean() * 5, 0, 1))
                silence_score = float(np.clip(
                    1.0 - (np.abs(seg) < 1e-3).mean(), 0, 1))
                pol = [e["polarity"] for e in events
                       if e["start"] >= a and e["end"] < b]
                polarity_score = float(abs(np.mean(pol))) if pol else 0.0
                vad_score = float((np.abs(seg) > 1e-4).mean())
                total = (self.w[0] * silence_score
                         + self.w[1] * prosody_score
                         + self.w[2] * polarity_score
                         + self.w[3] * vad_score)
                scores.append({
                    "slice": [int(a), int(b)],
                    "silence": round(silence_score, 3),
                    "prosody": round(prosody_score, 3),
                    "polarity": round(polarity_score, 3),
                    "vad": round(vad_score, 3),
                    "total": round(total, 4),
                })
            ranked = sorted(range(len(scores)),
                            key=lambda i: -scores[i]["total"])
            write_json_atomic(d / "alignment.json", {
                "ranked_slices": [scores[i]["slice"] for i in ranked],
                "scores": scores,
            })
            results[spk] = {"n_slices": len(scores)}
        return {"speakers": results}
