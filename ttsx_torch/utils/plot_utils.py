"""Figure helpers for pipeline artifacts (a copy of
``ttsx/utils/plot_utils.py``).

Re-designs modules/utils/plot_utils.py:7-69 + drift/drift_utils.py:3-25
(plotly trend/segment/drift figures). Zero-dependency: emits inline-SVG
HTML so artifacts render anywhere; matplotlib is used when available for
PNG twins.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence


def _polyline(xs, ys, w, h, color) -> str:
    if not len(ys):
        return ""
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 - y0 < 1e-9:
        y1 = y0 + 1.0
    pts = " ".join(
        f"{(x - x0) / (x1 - x0 + 1e-9) * w:.1f},"
        f"{h - (y - y0) / (y1 - y0) * h:.1f}"
        for x, y in zip(xs, ys))
    return (f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>')


def trend_figure(series: Dict[str, Sequence[float]], title: str = "trend",
                 w: int = 640, h: int = 160) -> str:
    """Multi-series line chart -> SVG string."""
    colors = ["#3B6DB3", "#C24A3C", "#3F8F5A", "#8A63B8", "#B8863F"]
    body = []
    for i, (name, ys) in enumerate(series.items()):
        xs = list(range(len(ys)))
        c = colors[i % len(colors)]
        body.append(_polyline(xs, list(ys), w, h - 20, c))
        body.append(f'<text x="{4 + i * 90}" y="{h - 4}" fill="{c}" '
                    f'font-size="11">{name}</text>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}"><title>{title}</title>{"".join(body)}</svg>')


def segment_figure(segments: List[Dict], duration: float,
                   w: int = 640, h: int = 60) -> str:
    """Colored horizontal segment bar (per-speaker/emotion segments)."""
    palette = ["#3B6DB3", "#C24A3C", "#3F8F5A", "#8A63B8", "#B8863F",
               "#4A9DA8"]
    keys = sorted({s.get("label", s.get("dominant_emotion", "?"))
                   for s in segments})
    body = []
    for s in segments:
        key = s.get("label", s.get("dominant_emotion", "?"))
        c = palette[keys.index(key) % len(palette)]
        x = s["start"] / max(duration, 1e-9) * w
        ww = (s["end"] - s["start"]) / max(duration, 1e-9) * w
        body.append(f'<rect x="{x:.1f}" y="10" width="{max(ww, 1):.1f}" '
                    f'height="30" fill="{c}"><title>{key}</title></rect>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}">{"".join(body)}</svg>')


def drift_figure(deltas: Sequence[float], events: List[Dict],
                 w: int = 640, h: int = 160) -> str:
    """Delta trace with shaded drift events."""
    svg = [trend_figure({"delta": list(deltas)}, "drift", w, h)[:-6]]
    n = max(len(deltas), 1)
    for ev in events:
        x = ev["start"] / n * w
        ww = max((ev["end"] - ev["start"] + 1) / n * w, 2)
        color = "#3F8F5A" if ev.get("polarity", 1) > 0 else "#C24A3C"
        svg.append(f'<rect x="{x:.1f}" y="0" width="{ww:.1f}" '
                   f'height="{h - 20}" fill="{color}" opacity="0.15"/>')
    svg.append("</svg>")
    return "".join(svg)


def heatmap_figure(mat, title: str = "similarity", w: int = 320,
                   h: int = 320, max_cells: int = 96) -> str:
    """Matrix heatmap -> SVG (the sim_matrix.png of reference
    hyper_diarizer/cli.py:46-50). Downsamples to max_cells per side so
    the artifact stays small for long runs."""
    import numpy as np
    m = np.asarray(mat, np.float32)
    if m.ndim != 2 or m.size == 0:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}"/>'
    if max(m.shape) > max_cells:
        f0 = -(-m.shape[0] // max_cells)
        f1 = -(-m.shape[1] // max_cells)
        p0 = (-m.shape[0]) % f0
        p1 = (-m.shape[1]) % f1
        m = np.pad(m, ((0, p0), (0, p1)), mode="edge")
        m = m.reshape(m.shape[0] // f0, f0, m.shape[1] // f1, f1
                      ).mean((1, 3))
    lo, hi = float(m.min()), float(m.max())
    span = max(hi - lo, 1e-9)
    # 3-stop dark-blue -> teal -> yellow ramp (viridis-like)
    stops = [(68, 1, 84), (33, 145, 140), (253, 231, 37)]

    def color(v):
        t = (v - lo) / span * 2
        i = min(int(t), 1)
        f = t - i
        c = [round(stops[i][k] + f * (stops[i + 1][k] - stops[i][k]))
             for k in range(3)]
        return f"rgb({c[0]},{c[1]},{c[2]})"

    cw, chh = w / m.shape[1], h / m.shape[0]
    body = [f'<rect x="{j * cw:.1f}" y="{i * chh:.1f}" '
            f'width="{cw + 0.5:.1f}" height="{chh + 0.5:.1f}" '
            f'fill="{color(float(m[i, j]))}"/>'
            for i in range(m.shape[0]) for j in range(m.shape[1])]
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}"><title>{title}</title>{"".join(body)}</svg>')


def diarization_timeline_figure(slices: List, speakers: List[str],
                                duration: float, overlaps: List = (),
                                w: int = 800, row_h: int = 26) -> str:
    """Per-speaker slice timeline with overlap shading (the timeline.html
    of reference hyper_diarizer/cli.py:52-55, one row per speaker instead
    of stacked vrects)."""
    palette = ["#3B6DB3", "#C24A3C", "#3F8F5A", "#8A63B8", "#B8863F",
               "#4A9DA8", "#A84A78", "#6D8F3F"]
    rows = sorted(set(speakers))
    dur = max(float(duration), 1e-9)
    h = (len(rows) + 1) * row_h + 24
    body = []
    for r, spk in enumerate(rows):
        y = r * row_h + 18
        c = palette[r % len(palette)]
        body.append(f'<text x="2" y="{y + row_h * 0.6:.0f}" font-size="11" '
                    f'fill="{c}">{spk}</text>')
        for (s, e), who in zip(slices, speakers):
            if who != spk:
                continue
            x = 60 + s / dur * (w - 64)
            ww = max((e - s) / dur * (w - 64), 1.0)
            body.append(f'<rect x="{x:.1f}" y="{y:.0f}" width="{ww:.1f}" '
                        f'height="{row_h - 6}" fill="{c}">'
                        f'<title>{spk} {s:.2f}-{e:.2f}s</title></rect>')
    oy = len(rows) * row_h + 18
    body.append(f'<text x="2" y="{oy + row_h * 0.6:.0f}" font-size="11" '
                f'fill="#666">overlap</text>')
    for ov in overlaps:
        s, e = float(ov[0]), float(ov[1])
        x = 60 + s / dur * (w - 64)
        ww = max((e - s) / dur * (w - 64), 1.0)
        body.append(f'<rect x="{x:.1f}" y="{oy:.0f}" width="{ww:.1f}" '
                    f'height="{row_h - 6}" fill="#666" opacity="0.5"/>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}"><title>diarization timeline</title>'
            f'{"".join(body)}</svg>')


def save_html(figures: Sequence[str], path: str | Path,
              title: str = "figures") -> None:
    html = (f"<html><head><title>{title}</title></head><body>"
            + "<hr/>".join(figures) + "</body></html>")
    Path(path).write_text(html)
