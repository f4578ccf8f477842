"""Report framework: logical document tree + text and HTML renderers.

Re-design of the reference's reporting stack (reference:
photon-ml/src/main/scala/com/linkedin/photon/ml/diagnostics/reporting/):
a *logical* report (document → chapters → sections → items) is transformed
to a *physical* rendering by pluggable strategies — text
(text/StringRenderStrategy) and HTML (html/HTMLRenderStrategy.scala:24,
which uses scala-xml + xchart there; plain HTML + inline SVG sparkline-style
plots here, no dependencies).

A copy of ``photon_ml_tpu/diagnostics/reporting.py`` (numpy and scipy only),
importing the port's own modules.
"""

from __future__ import annotations

import dataclasses
import html as html_mod
from typing import Sequence, Union

import numpy as np


# -- logical structure -------------------------------------------------------


@dataclasses.dataclass
class SimpleText:
    text: str


@dataclasses.dataclass
class BulletedList:
    items: list[str]


@dataclasses.dataclass
class Table:
    header: list[str]
    rows: list[list[str]]
    caption: str = ""


@dataclasses.dataclass
class LinePlot:
    """Series over a shared x axis (the xchart plot analog)."""

    x: np.ndarray
    series: dict[str, np.ndarray]
    title: str = ""
    x_label: str = ""
    y_label: str = ""


ReportItem = Union[SimpleText, BulletedList, Table, LinePlot]


@dataclasses.dataclass
class Section:
    title: str
    items: list[ReportItem] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Chapter:
    title: str
    sections: list[Section] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Document:
    title: str
    chapters: list[Chapter] = dataclasses.field(default_factory=list)


# -- text renderer -----------------------------------------------------------


def render_text(doc: Document) -> str:
    out: list[str] = [doc.title, "=" * len(doc.title), ""]
    for ci, chapter in enumerate(doc.chapters, 1):
        head = f"{ci}. {chapter.title}"
        out += [head, "-" * len(head), ""]
        for si, section in enumerate(chapter.sections, 1):
            out.append(f"{ci}.{si} {section.title}")
            for item in section.items:
                out.extend(_text_item(item))
            out.append("")
    return "\n".join(out)


def _text_item(item: ReportItem) -> list[str]:
    if isinstance(item, SimpleText):
        return ["  " + line for line in item.text.splitlines()]
    if isinstance(item, BulletedList):
        return [f"  * {x}" for x in item.items]
    if isinstance(item, Table):
        widths = [max(len(str(h)), *(len(str(r[i])) for r in item.rows))
                  if item.rows else len(str(h))
                  for i, h in enumerate(item.header)]
        lines = []
        if item.caption:
            lines.append(f"  [{item.caption}]")
        lines.append("  " + " | ".join(
            str(h).ljust(w) for h, w in zip(item.header, widths)))
        lines.append("  " + "-+-".join("-" * w for w in widths))
        for r in item.rows:
            lines.append("  " + " | ".join(
                str(v).ljust(w) for v, w in zip(r, widths)))
        return lines
    if isinstance(item, LinePlot):
        lines = [f"  [plot] {item.title} ({item.x_label} vs {item.y_label})"]
        for name, ys in item.series.items():
            pts = ", ".join(f"({float(x):.3g}, {float(y):.4g})"
                            for x, y in zip(item.x, ys))
            lines.append(f"    {name}: {pts}")
        return lines
    raise TypeError(f"unknown report item {type(item)}")


# -- HTML renderer -----------------------------------------------------------

_CSS = """
body { font-family: sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { border-bottom: 1px solid #999; }
table { border-collapse: collapse; margin: 0.5em 0; }
td, th { border: 1px solid #bbb; padding: 2px 8px; }
caption { font-style: italic; }
svg { background: #fafafa; border: 1px solid #ddd; }
"""

_PLOT_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"]


def _svg_line_plot(plot: LinePlot, width: int = 560, height: int = 320) -> str:
    """Dependency-free inline SVG with axes, labels and a legend."""
    pad = 48
    xs = np.asarray(plot.x, np.float64)
    all_y = np.concatenate([np.asarray(v, np.float64)
                            for v in plot.series.values()]) \
        if plot.series else np.asarray([0.0])
    finite_y = all_y[np.isfinite(all_y)]
    if len(xs) == 0 or len(finite_y) == 0:
        return f"<p>(empty plot: {html_mod.escape(plot.title)})</p>"
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(finite_y.min()), float(finite_y.max())
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0

    def sx(x: float) -> float:
        return pad + (x - x0) / (x1 - x0) * (width - 2 * pad)

    def sy(y: float) -> float:
        return height - pad - (y - y0) / (y1 - y0) * (height - 2 * pad)

    parts = [f'<svg width="{width}" height="{height}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    parts.append(
        f'<text x="{width / 2}" y="16" text-anchor="middle" '
        f'font-size="13">{html_mod.escape(plot.title)}</text>')
    # axes
    parts.append(f'<line x1="{pad}" y1="{height - pad}" x2="{width - pad}" '
                 f'y2="{height - pad}" stroke="#444"/>')
    parts.append(f'<line x1="{pad}" y1="{pad}" x2="{pad}" '
                 f'y2="{height - pad}" stroke="#444"/>')
    parts.append(f'<text x="{width / 2}" y="{height - 8}" '
                 f'text-anchor="middle" font-size="11">'
                 f'{html_mod.escape(plot.x_label)}</text>')
    parts.append(f'<text x="12" y="{height / 2}" font-size="11" '
                 f'transform="rotate(-90 12 {height / 2})" '
                 f'text-anchor="middle">'
                 f'{html_mod.escape(plot.y_label)}</text>')
    for tick_frac in (0.0, 0.5, 1.0):
        tx = x0 + tick_frac * (x1 - x0)
        ty = y0 + tick_frac * (y1 - y0)
        parts.append(f'<text x="{sx(tx)}" y="{height - pad + 14}" '
                     f'text-anchor="middle" font-size="10">{tx:.3g}</text>')
        parts.append(f'<text x="{pad - 6}" y="{sy(ty) + 3}" '
                     f'text-anchor="end" font-size="10">{ty:.3g}</text>')
    for k, (name, ys) in enumerate(plot.series.items()):
        ys = np.asarray(ys, np.float64)
        color = _PLOT_COLORS[k % len(_PLOT_COLORS)]
        pts = " ".join(f"{sx(float(x)):.1f},{sy(float(y)):.1f}"
                       for x, y in zip(xs, ys) if np.isfinite(y))
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="1.5"/>')
        ly = pad + 14 * k
        parts.append(f'<line x1="{width - pad - 70}" y1="{ly}" '
                     f'x2="{width - pad - 50}" y2="{ly}" stroke="{color}" '
                     f'stroke-width="2"/>')
        parts.append(f'<text x="{width - pad - 44}" y="{ly + 4}" '
                     f'font-size="10">{html_mod.escape(name)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _html_item(item: ReportItem) -> str:
    if isinstance(item, SimpleText):
        return f"<p>{html_mod.escape(item.text)}</p>"
    if isinstance(item, BulletedList):
        lis = "".join(f"<li>{html_mod.escape(x)}</li>" for x in item.items)
        return f"<ul>{lis}</ul>"
    if isinstance(item, Table):
        cap = (f"<caption>{html_mod.escape(item.caption)}</caption>"
               if item.caption else "")
        head = "".join(f"<th>{html_mod.escape(str(h))}</th>"
                       for h in item.header)
        rows = "".join(
            "<tr>" + "".join(f"<td>{html_mod.escape(str(v))}</td>"
                             for v in r) + "</tr>"
            for r in item.rows)
        return (f"<table>{cap}<thead><tr>{head}</tr></thead>"
                f"<tbody>{rows}</tbody></table>")
    if isinstance(item, LinePlot):
        return _svg_line_plot(item)
    raise TypeError(f"unknown report item {type(item)}")


def render_html(doc: Document) -> str:
    body: list[str] = [f"<h1>{html_mod.escape(doc.title)}</h1>"]
    for ci, chapter in enumerate(doc.chapters, 1):
        body.append(f"<h2>{ci}. {html_mod.escape(chapter.title)}</h2>")
        for si, section in enumerate(chapter.sections, 1):
            body.append(
                f"<h3>{ci}.{si} {html_mod.escape(section.title)}</h3>")
            body.extend(_html_item(item) for item in section.items)
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'/>"
            f"<title>{html_mod.escape(doc.title)}</title>"
            f"<style>{_CSS}</style></head><body>"
            + "".join(body) + "</body></html>")
