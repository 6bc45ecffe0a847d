"""Observer review dashboard.

Re-designs modules/observer/observer.py:29-231 — a 3-tab review surface
(global prosody trends, per-speaker paginated label correction over the
31-emotion vocabulary with notes + severity, beats timeline) committing
corrections to learned_rules.json.

Two frontends over one `ReviewSession` core:
  * Streamlit app (when streamlit is importable): `render_streamlit(ctx)`.
  * Headless API + static HTML report: works everywhere, drives tests,
    and is what the dynamic-learning stage consumes.

A copy of ``ttsx/pipeline/observer_ui.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from ttsx_torch.pipeline.contracts import read_json, write_json_atomic
from ttsx_torch.pipeline.emotion_utils import EMOTION_LABELS


class ReviewSession:
    """Correction workflow: list pending tags, apply corrections, commit."""

    def __init__(self, output_dir: str, page_size: int = 10):
        self.output_dir = Path(output_dir)
        self.page_size = page_size

    # -- reads -------------------------------------------------------------
    def speakers(self) -> List[str]:
        root = self.output_dir / "emotion_tags"
        return sorted(p.name for p in root.glob("*") if p.is_dir()) \
            if root.exists() else []

    def pending(self, speaker: str, page: int = 0) -> List[Dict]:
        tags = read_json(self.output_dir / "emotion_tags" / speaker /
                         "tier2_tags.json", {"tags": []})["tags"]
        todo = [t for t in tags if t.get("status") != "auto-accept"]
        lo = page * self.page_size
        return todo[lo:lo + self.page_size]

    def prosody_trend(self, speaker: str) -> Dict:
        return read_json(self.output_dir / "emotion_tags" / speaker /
                         "prosody_trend.json", {})

    def beats(self) -> List[Dict]:
        return read_json(self.output_dir / "plot_map.json",
                         {"beats": []})["beats"]

    # -- writes ------------------------------------------------------------
    def correct(self, speaker: str, start: float, label: str,
                notes: str = "", severity: str = "minor") -> None:
        if label not in EMOTION_LABELS:
            raise ValueError(f"unknown emotion label '{label}'")
        path = self.output_dir / "learned_rules.json"
        rules = read_json(path, {})
        rules.setdefault(speaker, {})[str(start)] = {
            "label": label, "notes": notes, "severity": severity}
        write_json_atomic(path, rules)

    # -- static report -----------------------------------------------------
    def html_report(self, path: Optional[str] = None) -> str:
        parts = ["<html><body><h1>Observer review</h1>"]
        for spk in self.speakers():
            trend = self.prosody_trend(spk)
            parts.append(f"<h2>{spk}</h2><p>voiced ratio: "
                         f"{trend.get('voiced_ratio', 0):.2f}</p><table "
                         f"border=1><tr><th>start</th><th>label</th>"
                         f"<th>conf</th><th>status</th><th>text</th></tr>")
            for t in self.pending(spk, 0):
                parts.append(
                    f"<tr><td>{t.get('start', 0)}</td><td>{t['label']}</td>"
                    f"<td>{t['confidence']}</td><td>{t['status']}</td>"
                    f"<td>{t.get('text', '')}</td></tr>")
            parts.append("</table>")
        parts.append("<h2>Beats</h2><ol>")
        for b in self.beats():
            parts.append(f"<li>{b['title']} — {b['dominant_emotion']} "
                         f"({b['start']}s–{b['end']}s)</li>")
        parts.append("</ol></body></html>")
        html = "".join(parts)
        if path:
            Path(path).write_text(html)
        return html


def render_streamlit(output_dir: str):  # pragma: no cover - needs streamlit
    """3-tab Streamlit UI (observer.py:29-231)."""
    import streamlit as st

    sess = ReviewSession(output_dir)
    tab1, tab2, tab3 = st.tabs(["Prosody", "Review", "Beats"])
    with tab1:
        for spk in sess.speakers():
            trend = sess.prosody_trend(spk)
            if trend.get("f0"):
                st.subheader(spk)
                st.line_chart({"f0": trend["f0"],
                               "energy": trend.get("energy", [])})
    with tab2:
        spk = st.selectbox("Speaker", sess.speakers())
        page = st.number_input("Page", 0, 100, 0)
        for t in sess.pending(spk, int(page)):
            with st.expander(f"{t.get('start', 0)}s: {t['label']} "
                             f"({t['confidence']})"):
                label = st.selectbox("Correct label", EMOTION_LABELS,
                                     index=EMOTION_LABELS.index(t["label"]),
                                     key=f"lbl{t.get('start')}")
                notes = st.text_input("Notes", key=f"n{t.get('start')}")
                severity = st.radio("Severity", ["minor", "major"],
                                    key=f"s{t.get('start')}")
                if st.button("Commit", key=f"c{t.get('start')}"):
                    sess.correct(spk, t.get("start", 0.0), label, notes,
                                 severity)
    with tab3:
        for b in sess.beats():
            st.write(f"**{b['title']}** — {b['dominant_emotion']} "
                     f"({b['start']}s–{b['end']}s)")
