"""Plot-map stage: micro-beats, titles, insights, HTML artifacts.

Re-designs modules/plot_map/plot_map.py:20-506: splits arc segments into
micro-beats (beats_per_arc, falling back to time chunks), titles each beat,
computes dominant emotion + speaker insights, back-annotates beat_ids into
drift_vector.json, and writes plot_map.json + per-beat HTML.

The BART-large-CNN summarizer is an external service (SURVEY §2.9);
`summarize_fn` plugs it in — the default builds extractive titles from the
beat's most polarized sentence.

A copy of ``ttsx/pipeline/plot_map.py`` but for its log: the reference
attaches a rotating handler per job directory to its logger and leaves
them open, so a watcher piles up one per job; the stage here keeps one
(``utils.logs.LogFile``), moved to each job's ``plot_map.log``.
"""
from __future__ import annotations

import logging
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json
from ttsx_torch.pipeline.sentiment import polarity_scores
from ttsx_torch.utils.logs import LogFile

log = logging.getLogger("ttsx_torch.plot_map")


def default_summarize(texts: List[str], max_words: int = 12) -> str:
    """Extractive fallback: the most sentiment-polarized sentence,
    truncated."""
    if not texts:
        return "(silence)"
    scored = [(abs(polarity_scores(t)["compound"]), t) for t in texts if t]
    if not scored:
        return "(untranscribed)"
    best = max(scored)[1]
    words = best.split()
    return " ".join(words[:max_words]) + ("…" if len(words) > max_words
                                          else "")


def _beat_html(beat: Dict) -> str:
    rows = "".join(
        f"<tr><td>{t['speaker']}</td><td>{t['start']:.1f}s</td>"
        f"<td>{t['label']}</td><td>{t['text']}</td></tr>"
        for t in beat["tags"])
    return (f"<html><body><h2>Beat {beat['beat_id']}: {beat['title']}</h2>"
            f"<p>dominant: <b>{beat['dominant_emotion']}</b> "
            f"({beat['start']:.1f}s – {beat['end']:.1f}s)</p>"
            f"<table border=1>{rows}</table></body></html>")


class PlotMapStage(Stage):
    name = "plot_map"

    def __init__(self, beats_per_arc: int = 3, chunk_s: float = 60.0,
                 summarize_fn: Optional[Callable] = None,
                 write_html: bool = True):
        self.beats_per_arc = beats_per_arc
        self.chunk_s = chunk_s
        self.summarize = summarize_fn or default_summarize
        self.write_html = write_html
        self._log = LogFile(log)

    def _make_beat(self, beat_id, a: float, b: float, all_tags: List[Dict],
                   title_suffix: str = "") -> Dict:
        tags = [t for t in all_tags if a <= t.get("start", 0.0) < b]
        dom = (Counter(t["label"] for t in tags).most_common(1)[0][0]
               if tags else "neutral")
        speakers = Counter(t["speaker"] for t in tags)
        return {
            "beat_id": beat_id,
            "start": round(a, 2), "end": round(b, 2),
            "title": self.summarize([t["text"] for t in tags])
                     + title_suffix,
            "dominant_emotion": dom,
            "speaker_insights": {
                s: {"n_tags": c,
                    "dominant": Counter(
                        t["label"] for t in tags
                        if t["speaker"] == s).most_common(1)[0][0]}
                for s, c in speakers.items()},
            "tags": tags,
        }

    def run(self, context: Dict) -> Dict:
        out_dir = Path(context["output_dir"])
        # bounded stage log (ref plot_map.py:14-18 RotatingFileHandler):
        # the stage's one handler, moved to this job's directory
        self._log.point(out_dir / "plot_map.log")
        arc = read_json(out_dir / "arc_classification.json", {})
        all_tags: List[Dict] = []
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            for t in read_json(d / "tier2_tags.json", {"tags": []})["tags"]:
                all_tags.append({**t, "speaker": spk})
        all_tags.sort(key=lambda t: t.get("start", 0.0))

        # beat boundaries: arc segments / beats_per_arc, else time chunks
        segments = arc.get("segments", [])
        bounds: List[float] = []
        if segments:
            for seg in segments:
                span = seg["end"] - seg["start"]
                for b in range(self.beats_per_arc):
                    bounds.append(seg["start"]
                                  + span * b / self.beats_per_arc)
            bounds.append(segments[-1]["end"])
        elif all_tags:
            end = max(t.get("end", 0.0) for t in all_tags)
            bounds = list(np.arange(0.0, end + self.chunk_s, self.chunk_s))
        bounds = sorted(set(bounds))

        beats = [self._make_beat(i, a, b, all_tags)
                 for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]

        # pivot-aligned beat boundaries (ref plot_map.py:432-443): an arc
        # pivot falling strictly inside a beat splits it into pre/post
        # halves; the post half gets beat_id "<id>.5" like the reference
        pivots = sorted(float(p) for p in arc.get("pivots", []))
        if pivots:
            adjusted, pi = [], 0
            for beat in beats:
                while pi < len(pivots) and pivots[pi] <= beat["start"]:
                    pi += 1
                if pi < len(pivots) and beat["start"] < pivots[pi] < beat["end"]:
                    p = pivots[pi]
                    adjusted.append(self._make_beat(
                        beat["beat_id"], beat["start"], p, all_tags,
                        title_suffix=" (pre-pivot)"))
                    adjusted.append(self._make_beat(
                        f"{beat['beat_id']}.5", p, beat["end"], all_tags,
                        title_suffix=" (post-pivot)"))
                else:
                    adjusted.append(beat)
            beats = adjusted

        maps_dir = out_dir / "plot_maps"
        if self.write_html:
            maps_dir.mkdir(parents=True, exist_ok=True)
            for j, beat in enumerate(beats):
                (maps_dir / f"beat_{j:03d}.html").write_text(
                    _beat_html(beat))

        # back-annotate beat_ids into each speaker's drift_vector.json
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            drift = read_json(d / "drift_vector.json", {})
            spk_tags = [t for t in all_tags if t["speaker"] == spk]
            beat_ids = []
            for t in spk_tags:
                bid = next((b["beat_id"] for b in beats
                            if b["start"] <= t.get("start", 0.0) < b["end"]),
                           -1)
                beat_ids.append(bid)
            drift["beat_ids"] = beat_ids
            write_json_atomic(d / "drift_vector.json", drift)

        out = {"beats": [{k: v for k, v in b.items() if k != "tags"}
                         for b in beats],
               "n_beats": len(beats), "pivots": pivots}
        write_json_atomic(out_dir / "plot_map.json", out)
        return {"n_beats": len(beats)}
