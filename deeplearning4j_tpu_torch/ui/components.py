"""Chart/component DSL (deeplearning4j-ui-components analog): the port's copy
of `deeplearning4j_tpu/ui/components.py`, framework-free, rendering the same
bytes.

Reference (SURVEY.md §2.9): `ui/components/{chart,component,table,text,
decorator}/` — a Java chart DSL serialized to JSON and rendered by bundled
TypeScript. Here the DSL serializes to the same kind of JSON AND renders
itself to dependency-free inline SVG/HTML (no TS toolchain; works offline),
which is also what the training dashboard embeds.
"""
from __future__ import annotations

import html as _html
import json
from typing import List, Optional, Sequence, Tuple

__all__ = ["StyleChart", "ChartLine", "ChartScatter", "ChartHistogram",
           "ComponentTable", "ComponentText", "render_page"]


class StyleChart:
    """Subset of the reference's StyleChart: size + series colors."""

    _PALETTE = ["#1971c2", "#e8590c", "#2f9e44", "#9c36b5", "#e03131",
                "#0c8599"]

    def __init__(self, width: int = 480, height: int = 280,
                 colors: Optional[Sequence[str]] = None):
        self.width = int(width)
        self.height = int(height)
        self.colors = list(colors) if colors else list(self._PALETTE)

    def to_dict(self):
        return {"width": self.width, "height": self.height,
                "colors": self.colors}


class _Component:
    kind = "component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps({"type": self.kind, **self.to_dict()})

    def render_svg(self) -> str:
        raise NotImplementedError


def _axes(style: StyleChart, x_min, x_max, y_min, y_max, title):
    w, h = style.width, style.height
    parts = [f'<svg width="{w}" height="{h}" '
             f'xmlns="http://www.w3.org/2000/svg" '
             f'style="background:#fff;border:1px solid #ddd">']
    if title:
        parts.append(f'<text x="{w // 2}" y="14" text-anchor="middle" '
                     f'font-size="12">{_html.escape(title)}</text>')
    for frac, val in ((0.0, y_max), (1.0, y_min)):
        y = 20 + frac * (h - 40)
        parts.append(f'<text x="4" y="{y:.0f}" font-size="9">'
                     f'{val:.3g}</text>')
    for frac, val in ((0.0, x_min), (1.0, x_max)):
        x = 35 + frac * (w - 50)
        parts.append(f'<text x="{x:.0f}" y="{h - 4}" font-size="9">'
                     f'{val:.3g}</text>')
    return parts


def _scale(xs, ys, style: StyleChart, x_rng, y_rng):
    w, h = style.width, style.height
    (x0, x1), (y0, y1) = x_rng, y_rng
    sx = (x1 - x0) or 1.0
    sy = (y1 - y0) or 1.0
    px = [35 + (x - x0) / sx * (w - 50) for x in xs]
    py = [20 + (1 - (y - y0) / sy) * (h - 40) for y in ys]
    return px, py


class ChartLine(_Component):
    """Multi-series line chart (`chart/ChartLine.java`)."""

    kind = "chart-line"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def to_dict(self):
        return {"title": self.title, "style": self.style.to_dict(),
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    def _ranges(self):
        xs = [v for _, x, _ in self.series for v in x] or [0.0, 1.0]
        ys = [v for _, _, y in self.series for v in y] or [0.0, 1.0]
        return (min(xs), max(xs)), (min(ys), max(ys))

    def render_svg(self) -> str:
        x_rng, y_rng = self._ranges()
        parts = _axes(self.style, *x_rng, *y_rng, self.title)
        for i, (name, x, y) in enumerate(self.series):
            color = self.style.colors[i % len(self.style.colors)]
            px, py = _scale(x, y, self.style, x_rng, y_rng)
            pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
            parts.append(f'<polyline fill="none" stroke="{color}" '
                         f'stroke-width="1.5" points="{pts}"/>')
            parts.append(f'<text x="{self.style.width - 8}" '
                         f'y="{20 + 12 * i}" text-anchor="end" '
                         f'font-size="10" fill="{color}">'
                         f'{_html.escape(name)}</text>')
        parts.append("</svg>")
        return "".join(parts)


class ChartScatter(ChartLine):
    """Scatter chart (`chart/ChartScatter.java`)."""

    kind = "chart-scatter"

    def render_svg(self) -> str:
        x_rng, y_rng = self._ranges()
        parts = _axes(self.style, *x_rng, *y_rng, self.title)
        for i, (name, x, y) in enumerate(self.series):
            color = self.style.colors[i % len(self.style.colors)]
            px, py = _scale(x, y, self.style, x_rng, y_rng)
            for a, b in zip(px, py):
                parts.append(f'<circle cx="{a:.1f}" cy="{b:.1f}" r="2.2" '
                             f'fill="{color}" fill-opacity="0.7"/>')
            parts.append(f'<text x="{self.style.width - 8}" '
                         f'y="{20 + 12 * i}" text-anchor="end" '
                         f'font-size="10" fill="{color}">'
                         f'{_html.escape(name)}</text>')
        parts.append("</svg>")
        return "".join(parts)


class ChartHistogram(_Component):
    """Histogram chart (`chart/ChartHistogram.java`): explicit bin edges."""

    kind = "chart-histogram"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()
        self.bins: List[Tuple[float, float, float]] = []  # (lo, hi, count)

    def add_bin(self, low: float, high: float,
                count: float) -> "ChartHistogram":
        self.bins.append((float(low), float(high), float(count)))
        return self

    def to_dict(self):
        return {"title": self.title, "style": self.style.to_dict(),
                "bins": [{"low": lo, "high": hi, "count": c}
                         for lo, hi, c in self.bins]}

    def render_svg(self) -> str:
        if not self.bins:
            return "<svg/>"
        x0 = min(lo for lo, _, _ in self.bins)
        x1 = max(hi for _, hi, _ in self.bins)
        y1 = max(c for _, _, c in self.bins) or 1.0
        parts = _axes(self.style, x0, x1, 0.0, y1, self.title)
        w, h = self.style.width, self.style.height
        sx = (x1 - x0) or 1.0
        for lo, hi, c in self.bins:
            px = 35 + (lo - x0) / sx * (w - 50)
            pw = max(1.0, (hi - lo) / sx * (w - 50) - 1)
            ph = c / y1 * (h - 40)
            parts.append(
                f'<rect x="{px:.1f}" y="{h - 20 - ph:.1f}" '
                f'width="{pw:.1f}" height="{ph:.1f}" '
                f'fill="{self.style.colors[0]}" fill-opacity="0.8"/>')
        parts.append("</svg>")
        return "".join(parts)


class ComponentTable(_Component):
    """Simple table (`table/ComponentTable.java`)."""

    kind = "component-table"

    def __init__(self, header: Sequence[str],
                 rows: Sequence[Sequence[object]]):
        self.header = [str(hh) for hh in header]
        self.rows = [[str(c) for c in row] for row in rows]

    def to_dict(self):
        return {"header": self.header, "rows": self.rows}

    def render_svg(self) -> str:   # tables render as HTML
        head = "".join(f"<th>{_html.escape(hh)}</th>"
                       for hh in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(c)}</td>" for c in row)
            + "</tr>" for row in self.rows)
        return (f'<table border="1" cellspacing="0" cellpadding="4">'
                f"<tr>{head}</tr>{body}</table>")


class ComponentText(_Component):
    kind = "component-text"

    def __init__(self, text: str):
        self.text = text

    def to_dict(self):
        return {"text": self.text}

    def render_svg(self) -> str:
        return f"<p>{_html.escape(self.text)}</p>"


def render_page(title: str, components: Sequence[_Component]) -> str:
    """Standalone HTML page embedding the rendered components (the role of
    the reference's TS renderer bundle)."""
    body = "<br/>".join(c.render_svg() for c in components)
    t = _html.escape(title)
    return (f"<!DOCTYPE html><html><head><title>{t}</title></head>"
            f"<body style='font-family:sans-serif'><h2>{t}</h2>"
            f"{body}</body></html>")
