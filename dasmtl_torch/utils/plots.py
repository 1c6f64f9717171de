"""Post-run rendering of metric curves and confusion matrices.

Counterpart of ``dasmtl/utils/plots.py``: after a run every 1-D metric
line in ``metrics/`` becomes ``<stem>.png`` (reference utils.py:180-204)
and every ``confusion_matrix*.npy`` becomes ``<stem>.svg`` with the class
names ``['0m'..'15m']`` / ``['Striking', 'Excavating']`` (utils.py:51-75,
207-221).  The card's host has no matplotlib, so the renderer is this
module's own, built from numpy, ``zlib`` and ``struct``:

- a curve is a 720 x 480 8-bit RGB PNG (JAX's 6 x 4 in at dpi 120): one
  ``IDAT`` chunk of filter-0 rows, axes with "nice" ticks, a light grid
  (JAX's alpha 0.3 over white), the polyline of the values in
  matplotlib's first colour, and text from the 5 x 7 bitmap font below
  (printable ASCII), drawn at twice its size;
- a confusion matrix is a plain-text SVG: one ``<rect class="cell">`` a
  cell, filled from matplotlib's ``Blues`` (256 levels interpolated over
  its 9 ColorBrewer stops, normalised over ``[cm.min(), cm.max()]`` as
  ``imshow`` does), every count and label a ``<text>`` element (a count
  white above ``cm.max() / 2``, black otherwise), the x tick labels turned
  45 degrees, and a colorbar beside the matrix.

:func:`curve_axes` is the curve's data-to-pixel mapping, so a reader can
find the line's pixels from the values.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape

import numpy as np

DISTANCE_CLASS_NAMES = tuple(f"{k}m" for k in range(16))
EVENT_CLASS_NAMES = ("Striking", "Excavating")


def class_names_for(num_classes: int) -> Sequence[str]:
    """The reference distinguishes tasks by matrix size (utils.py:212-218)."""
    if num_classes == 2:
        return EVENT_CLASS_NAMES
    if num_classes == 16:
        return DISTANCE_CLASS_NAMES
    return tuple(str(i) for i in range(num_classes))


# -- the bitmap font -----------------------------------------------------------
#: 5 x 7 glyphs of printable ASCII (0x20-0x7e), five column bytes a glyph,
#: bit 0 the top row.
_FONT_HEX = (
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "007f414100"
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "1008081008")
_GLYPHS = np.unpackbits(
    np.frombuffer(bytes.fromhex(_FONT_HEX), np.uint8).reshape(95, 5, 1),
    axis=2, bitorder="little")[:, :, :7].transpose(0, 2, 1).astype(bool)
FONT_SCALE = 2
GLYPH_H = 7 * FONT_SCALE
GLYPH_ADVANCE = 6 * FONT_SCALE


def text_mask(text: str) -> np.ndarray:
    """A (14, 12 * len(text)) mask of ``text`` in the bitmap font at
    twice its size; a character outside printable ASCII draws as '?'."""
    cols = []
    for ch in text:
        code = ord(ch) - 0x20
        glyph = _GLYPHS[code if 0 <= code < 95 else ord("?") - 0x20]
        cols.append(np.pad(glyph, ((0, 0), (0, 1))))
    if not cols:
        return np.zeros((GLYPH_H, 0), bool)
    mask = np.concatenate(cols, axis=1)
    return mask.repeat(FONT_SCALE, 0).repeat(FONT_SCALE, 1)


# -- PNG curves ----------------------------------------------------------------
WIDTH, HEIGHT = 720, 480
#: matplotlib's first line colour, C0 (#1f77b4).
LINE_RGB = (0x1F, 0x77, 0xB4)
#: matplotlib's grid colour (#b0b0b0) at alpha 0.3 over white.
GRID_RGB = (231, 231, 231)
TEXT_RGB = (0, 0, 0)
#: matplotlib's default axis margins: 5 % of the data range each side.
MARGIN = 0.05
_TICK = 5
_PAD = 4
_TOP = 12 + GLYPH_H + 12
_BOTTOM = _TICK + _PAD + GLYPH_H + 10 + GLYPH_H + 12
_RIGHT = 24
#: Past this many points a pixel column on average, a line draws each
#: column's first, lowest, highest and last point (the same pixels as
#: every point).
_DECIMATE_PER_COLUMN = 4


def nice_ticks(lo: float, hi: float, target: int = 6
               ) -> Tuple[float, List[float]]:
    """``(step, ticks)``: the ticks inside ``[lo, hi]`` at a step of 1, 2,
    2.5 or 5 times a power of ten, at most ``target + 1`` of them."""
    span = hi - lo
    mag = 10.0 ** math.floor(math.log10(span / target))
    step = 10.0 * mag
    for m in (1.0, 2.0, 2.5, 5.0):
        if span / (m * mag) <= target:
            step = m * mag
            break
    first = math.ceil(lo / step - 1e-9)
    last = math.floor(hi / step + 1e-9)
    return step, [k * step for k in range(first, last + 1)]


def tick_label(value: float, step: float) -> str:
    """``value`` with as many decimals as ``step`` needs."""
    exp = math.floor(math.log10(step) + 1e-9)
    decimals = max(0, -exp)
    if exp <= 0 and abs(step / 10.0 ** exp - 2.5) < 1e-6:
        decimals += 1  # 2.5, 0.25, ...
    text = f"{value:.{decimals}f}"
    if len(text) > 9:
        text = f"{value:.3g}"
    return "0" if text.strip("-0.") == "" else text


def _limits(lo: float, hi: float) -> Tuple[float, float]:
    if hi > lo:
        pad = MARGIN * (hi - lo)
        return lo - pad, hi + pad
    delta = MARGIN * abs(lo) if lo else MARGIN
    return lo - delta, hi + delta


@dataclasses.dataclass(frozen=True)
class CurveAxes:
    """A curve's data limits and plot box (pixels: left, top, right,
    bottom edges, right and bottom inclusive)."""

    x_lim: Tuple[float, float]
    y_lim: Tuple[float, float]
    box: Tuple[int, int, int, int]

    def x_px(self, x) -> np.ndarray:
        left, _, right, _ = self.box
        lo, hi = self.x_lim
        return left + (np.asarray(x, np.float64) - lo) / (hi - lo) * (
            right - left)

    def y_px(self, y) -> np.ndarray:
        _, top, _, bottom = self.box
        lo, hi = self.y_lim
        return top + (hi - np.asarray(y, np.float64)) / (hi - lo) * (
            bottom - top)


def curve_axes(values: np.ndarray) -> CurveAxes:
    """Where :func:`plot_curve` draws ``values``: x is the index, both
    limits the data range with :data:`MARGIN` each side."""
    values = np.asarray(values, np.float64).ravel()
    n = values.size
    finite = values[np.isfinite(values)]
    x_lim = _limits(0.0, float(max(n - 1, 0)))
    y_lim = (_limits(float(finite.min()), float(finite.max()))
             if finite.size else (-MARGIN, MARGIN))
    y_step, y_ticks = nice_ticks(*y_lim)
    label_w = max(text_mask(tick_label(t, y_step)).shape[1] for t in y_ticks)
    left = 10 + GLYPH_H + 10 + label_w + _PAD + _TICK
    return CurveAxes(x_lim, y_lim,
                     (left, _TOP, WIDTH - 1 - _RIGHT, HEIGHT - 1 - _BOTTOM))


def _paint(canvas: np.ndarray, mask: np.ndarray, x: int, y: int,
           rgb) -> None:
    """``mask`` painted with its top-left corner at (x, y), clipped."""
    h, w = mask.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, canvas.shape[0]), min(x + w, canvas.shape[1])
    if y1 <= y0 or x1 <= x0:
        return
    canvas[y0:y1, x0:x1][mask[y0 - y:y1 - y, x0 - x:x1 - x]] = rgb


def _kept(values: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Indices of the points to draw: all of them, or past
    :data:`_DECIMATE_PER_COLUMN` points a column, each column's first,
    lowest, highest and last finite point and the neighbours of every
    non-finite one."""
    n = values.size
    finite = np.isfinite(values)
    if n <= _DECIMATE_PER_COLUMN * WIDTH:
        return np.flatnonzero(finite)
    idx = np.flatnonzero(finite)
    c, v = cols[idx], values[idx]
    order = np.lexsort((v, c))  # by column, then value
    starts = np.flatnonzero(np.r_[True, c[order][1:] != c[order][:-1]])
    ends = np.r_[starts[1:], len(order)] - 1
    by_col = np.flatnonzero(np.r_[True, c[1:] != c[:-1], True])
    bad = np.flatnonzero(~finite)
    near = np.concatenate([bad - 1, bad + 1])
    near = near[(near >= 0) & (near < n)]
    return np.unique(np.concatenate([
        idx[order[starts]], idx[order[ends]], idx[by_col[:-1]],
        idx[by_col[1:] - 1], near[finite[near]]]))


def _polyline(canvas: np.ndarray, ax: CurveAxes, values: np.ndarray) -> None:
    """The line through the finite values, 3 px wide, broken at
    non-finite ones, clipped to the plot box."""
    values = np.asarray(values, np.float64).ravel()
    xs = ax.x_px(np.arange(values.size))
    keep = _kept(values, np.floor(xs).astype(np.int64))
    if keep.size == 0:
        return
    px, py = xs[keep], ax.y_px(values[keep])
    bad_before = np.cumsum(~np.isfinite(values))
    joined = (bad_before[keep[1:]] - bad_before[keep[:-1]]) == 0
    x0, y0 = px[:-1][joined], py[:-1][joined]
    dx, dy = px[1:][joined] - x0, py[1:][joined] - y0
    samples = np.ceil(np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1
    seg = np.repeat(np.arange(samples.size), samples)
    t = (np.arange(seg.size) - np.repeat(np.cumsum(samples) - samples,
                                         samples)) / np.maximum(
        samples[seg] - 1, 1)
    sx = np.concatenate([x0[seg] + t * dx[seg], px])
    sy = np.concatenate([y0[seg] + t * dy[seg], py])
    sx, sy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
    left, top, right, bottom = ax.box
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            x, y = sx + ox, sy + oy
            inside = (x >= left) & (x <= right) & (y >= top) & (y <= bottom)
            canvas[y[inside], x[inside]] = LINE_RGB


def render_curve(values: np.ndarray, title: str, ylabel: str,
                 xlabel: str = "step") -> np.ndarray:
    """The (480, 720, 3) uint8 image :func:`plot_curve` writes."""
    values = np.asarray(values, np.float64).ravel()
    ax = curve_axes(values)
    left, top, right, bottom = ax.box
    canvas = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    x_step, x_ticks = nice_ticks(*ax.x_lim)
    y_step, y_ticks = nice_ticks(*ax.y_lim)
    for t in x_ticks:
        x = int(round(float(ax.x_px(t))))
        canvas[top:bottom + 1, x] = GRID_RGB
        canvas[bottom + 1:bottom + 1 + _TICK, x] = TEXT_RGB
        label = text_mask(tick_label(t, x_step))
        _paint(canvas, label, x - label.shape[1] // 2,
               bottom + 1 + _TICK + _PAD, TEXT_RGB)
    for t in y_ticks:
        y = int(round(float(ax.y_px(t))))
        canvas[y, left:right + 1] = GRID_RGB
        canvas[y, left - _TICK:left] = TEXT_RGB
        label = text_mask(tick_label(t, y_step))
        _paint(canvas, label, left - _TICK - _PAD - label.shape[1],
               y - GLYPH_H // 2, TEXT_RGB)
    canvas[top, left:right + 1] = TEXT_RGB
    canvas[bottom, left:right + 1] = TEXT_RGB
    canvas[top:bottom + 1, left] = TEXT_RGB
    canvas[top:bottom + 1, right] = TEXT_RGB
    centre = (left + right) // 2
    label = text_mask(xlabel)
    _paint(canvas, label, centre - label.shape[1] // 2,
           HEIGHT - 12 - GLYPH_H, TEXT_RGB)
    label = text_mask(title)
    _paint(canvas, label, centre - label.shape[1] // 2, 12, TEXT_RGB)
    label = np.rot90(text_mask(ylabel))  # reads bottom to top
    _paint(canvas, label, 10, (top + bottom) // 2 - label.shape[0] // 2,
           TEXT_RGB)
    _polyline(canvas, ax, values)
    return canvas


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (h, w, 3) uint8 image as an 8-bit RGB PNG: one ``IDAT`` chunk,
    every row filter type 0."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(
                               h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def plot_curve(values: np.ndarray, title: str, ylabel: str,
               out_path: str, xlabel: str = "step") -> None:
    with open(out_path, "wb") as f:
        f.write(encode_png(render_curve(values, title, ylabel, xlabel)))


def plot_metric_lines(metrics_dir: str, out_dir: Optional[str] = None) -> list:
    """Render every ``*.npy`` metric line in ``metrics_dir`` to a PNG —
    the equivalent of the reference's post-run loop (utils.py:180-204)."""
    out_dir = out_dir or metrics_dir
    written = []
    for name in sorted(os.listdir(metrics_dir)):
        if not name.endswith(".npy") or "confusion" in name:
            continue
        values = np.load(os.path.join(metrics_dir, name))
        if values.ndim != 1 or values.size == 0:
            continue
        stem = name[:-4]
        out_path = os.path.join(out_dir, f"{stem}.png")
        plot_curve(values, stem.replace("_", " "), stem.split("_")[-1],
                   out_path)
        written.append(out_path)
    return written


# -- SVG confusion matrices ----------------------------------------------------
#: matplotlib's ``Blues``: the 9 ColorBrewer stops, evenly spaced.
BLUES_STOPS = np.array([
    (0.9686274509803922, 0.984313725490196, 1.0),
    (0.8705882352941177, 0.9215686274509803, 0.9686274509803922),
    (0.7764705882352941, 0.8588235294117647, 0.9372549019607843),
    (0.6196078431372549, 0.792156862745098, 0.8823529411764706),
    (0.4196078431372549, 0.6823529411764706, 0.8392156862745098),
    (0.25882352941176473, 0.5725490196078431, 0.7764705882352941),
    (0.12941176470588237, 0.44313725490196076, 0.7098039215686275),
    (0.03137254901960784, 0.3176470588235294, 0.611764705882353),
    (0.03137254901960784, 0.18823529411764706, 0.4196078431372549)])
BLUES_N = 256
BLUES_LUT = np.stack([np.interp(np.linspace(0.0, 1.0, BLUES_N),
                                np.linspace(0.0, 1.0, len(BLUES_STOPS)),
                                BLUES_STOPS[:, c]) for c in range(3)], 1)


def blues_rgb(cm: np.ndarray) -> np.ndarray:
    """(..., 3) RGB in [0, 1] of every entry: normalised over
    ``[cm.min(), cm.max()]`` (0 when they are equal), then the level
    ``min(int(v * 256), 255)`` of the 256-level map."""
    cm = np.asarray(cm, np.float64)
    lo, hi = (float(cm.min()), float(cm.max())) if cm.size else (0.0, 0.0)
    norm = (cm - lo) / (hi - lo) if hi > lo else np.zeros_like(cm)
    level = np.clip((norm * BLUES_N).astype(np.int64), 0, BLUES_N - 1)
    return BLUES_LUT[level]


def _hex(rgb) -> str:
    return "#" + "".join(f"{int(round(float(c) * 255)):02x}" for c in rgb)


#: Pixel sizes of the SVG's text (matplotlib's 10 pt labels, 7 pt counts).
_FONT, _COUNT_FONT, _CHAR_W = 10, 7, 6.0


def confusion_svg(cm: np.ndarray, class_names: Sequence[str],
                  title: str) -> str:
    """The SVG text of :func:`draw_confusion_matrix`."""
    cm = np.asarray(cm)
    n = cm.shape[0]
    names = [str(s) for s in class_names]
    cell = max(24, 400 // max(n, 1))
    label_w = _CHAR_W * max((len(s) for s in names), default=1)
    left = int(10 + _FONT + 14 + label_w + 6)
    top = 40
    side = n * cell
    bar_x = left + side + 20
    bottom = int(top + side + 6 + label_w * 0.71 + 16 + _FONT + 12)
    width = bar_x + 16 + 60
    lo, hi = (float(cm.min()), float(cm.max())) if cm.size else (0.0, 0.0)
    fills = blues_rgb(cm)
    thresh = cm.max() / 2 if cm.size else 0
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{bottom}" viewBox="0 0 {width} {bottom}" '
           f'font-family="DejaVu Sans, Arial, sans-serif" '
           f'font-size="{_FONT}">',
           '<defs><linearGradient id="blues" x1="0" y1="1" x2="0" y2="0">']
    for k, stop in enumerate(BLUES_STOPS):
        out.append(f'<stop offset="{k / (len(BLUES_STOPS) - 1):.4f}" '
                   f'stop-color="{_hex(stop)}"/>')
    out += ['</linearGradient></defs>',
            f'<rect width="{width}" height="{bottom}" fill="#ffffff"/>',
            f'<text class="title" x="{left + side / 2}" y="{top - 14}" '
            f'text-anchor="middle" font-size="{_FONT + 2}">'
            f'{escape(title)}</text>']
    for i in range(n):
        for j in range(n):
            x, y = left + j * cell, top + i * cell
            out.append(f'<rect class="cell" data-row="{i}" data-col="{j}" '
                       f'x="{x}" y="{y}" width="{cell}" height="{cell}" '
                       f'fill="{_hex(fills[i, j])}"/>')
            colour = "#ffffff" if cm[i, j] > thresh else "#000000"
            out.append(f'<text class="count" data-row="{i}" data-col="{j}" '
                       f'x="{x + cell / 2}" y="{y + cell / 2}" '
                       f'text-anchor="middle" dominant-baseline="central" '
                       f'font-size="{_COUNT_FONT}" fill="{colour}">'
                       f'{int(cm[i, j])}</text>')
    for k, name in enumerate(names):
        x, y = left + (k + 0.5) * cell, top + side + 6
        out.append(f'<text class="xtick" data-index="{k}" x="{x}" y="{y}" '
                   f'text-anchor="end" dominant-baseline="hanging" '
                   f'transform="rotate(-45 {x} {y})">{escape(name)}</text>')
        y = top + (k + 0.5) * cell
        out.append(f'<text class="ytick" data-index="{k}" x="{left - 6}" '
                   f'y="{y}" text-anchor="end" dominant-baseline="central">'
                   f'{escape(name)}</text>')
    out.append(f'<text class="xlabel" x="{left + side / 2}" '
               f'y="{bottom - 12}" text-anchor="middle">Predicted label'
               f'</text>')
    y = top + side / 2
    out.append(f'<text class="ylabel" x="{10 + _FONT}" y="{y}" '
               f'text-anchor="middle" transform="rotate(-90 {10 + _FONT} '
               f'{y})">True label</text>')
    out.append(f'<rect class="colorbar" x="{bar_x}" y="{top}" width="16" '
               f'height="{side}" fill="url(#blues)" stroke="#000000" '
               f'stroke-width="0.8"/>')
    if hi > lo:
        step, ticks = nice_ticks(lo, hi)
        for t in ticks:
            y = top + side - (t - lo) / (hi - lo) * side
            out.append(f'<text class="cbtick" x="{bar_x + 22}" y="{y}" '
                       f'dominant-baseline="central">'
                       f'{tick_label(t, step)}</text>')
    else:
        out.append(f'<text class="cbtick" x="{bar_x + 22}" '
                   f'y="{top + side / 2}" dominant-baseline="central">'
                   f'{tick_label(lo, 1.0)}</text>')
    out.append("</svg>")
    return "\n".join(out) + "\n"


def draw_confusion_matrix(cm: np.ndarray, out_path: str,
                          class_names: Optional[Sequence[str]] = None,
                          title: str = "confusion matrix") -> None:
    """Heatmap with counts annotated per cell, saved as SVG (reference
    utils.py:51-75)."""
    cm = np.asarray(cm)
    names = list(class_names or class_names_for(cm.shape[0]))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(confusion_svg(cm, names, title))


def render_confusion_matrices(metrics_dir: str,
                              out_dir: Optional[str] = None) -> list:
    """Render every saved ``confusion_matrix_*.npy`` to SVG (reference test
    mode, utils.py:207-221)."""
    out_dir = out_dir or metrics_dir
    written = []
    for name in sorted(os.listdir(metrics_dir)):
        if not (name.startswith("confusion_matrix") and name.endswith(".npy")):
            continue
        cm = np.load(os.path.join(metrics_dir, name))
        stem = name[:-4]
        out_path = os.path.join(out_dir, f"{stem}.svg")
        draw_confusion_matrix(cm, out_path, title=stem.replace("_", " "))
        written.append(out_path)
    return written
