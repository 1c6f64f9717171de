"""The port's plots (``dasmtl_torch/utils/plots.py``) against the JAX
package's matplotlib ones (``dasmtl/utils/plots.py``), on the CPU.

One metrics dir made with numpy from a seed (1-D lines, one long enough
that the renderer draws each pixel column's extremes, a 2-D array that is
no confusion matrix, an empty line, and 16 x 16 and 2 x 2 confusion
matrices, the 2 x 2 all zeros) goes through both packages'
``plot_metric_lines`` and ``render_confusion_matrices``, each on its own
copy:

- both write the same file names, and return them sorted;
- every port PNG decodes with ``matplotlib.image.imread`` (the test's
  import) to 480 x 720 x 3, its chunks and CRCs are sound, its title is
  drawn, and for every value the pixel column at its x holds a line pixel
  within 1 pixel of its y, by the port's own axis mapping;
- every port SVG parses, its count texts equal the matrix, every cell's
  fill is within 2/255 a channel of ``matplotlib.cm.Blues(norm(v))``
  with ``imshow``'s normalisation, a count is white exactly above
  ``max / 2``, and the tick labels are ``class_names_for(n)``.

The entry points' rendering is held in
``tests/test_torch_port_trainer.py`` (train, then test) and
``tests/test_torch_port_cv.py`` (``--cv_parallel``).
"""

import os
import shutil
import struct
import xml.etree.ElementTree as ET
import zlib

import matplotlib
import matplotlib.colors
import matplotlib.image
import numpy as np
import pytest

from dasmtl.utils import plots as jax_plots
from dasmtl_torch.utils import plots

LINE = np.array(plots.LINE_RGB) / 255.0
SVG = "{http://www.w3.org/2000/svg}"


def metrics_dir(root, seed=0):
    """The seeded metrics dir both renderers read."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    lines = {"train_loss": np.exp(-np.arange(240) / 60.0)
             + 0.05 * rng.random(240),
             "val_acc_distance": rng.uniform(0.2, 1.0, 7),
             "val_acc_event": np.array([0.5]),
             "val_loss": rng.normal(0, 1e3, 12),
             "fold3_train_loss": rng.normal(size=5000).cumsum()}
    for name, values in lines.items():
        np.save(os.path.join(root, f"{name}.npy"), values.astype(np.float32))
    np.save(os.path.join(root, "val_grid.npy"), rng.random((4, 3)))
    np.save(os.path.join(root, "val_empty.npy"), np.zeros(0, np.float32))
    np.save(os.path.join(root, "confusion_matrix_distance.npy"),
            rng.integers(0, 40, (16, 16)))
    np.save(os.path.join(root, "confusion_matrix_event.npy"),
            np.zeros((2, 2), np.int64))
    return root


def jax_artifact_names(metrics_dir_):
    """The PNG and SVG names ``dasmtl/main.py`` would write for the
    ``.npy`` files of ``metrics_dir_``: its renderer run on a copy."""
    copy = metrics_dir_.rstrip("/") + ".jax-copy"
    os.makedirs(copy)
    try:
        for name in os.listdir(metrics_dir_):
            if name.endswith(".npy"):
                shutil.copy(os.path.join(metrics_dir_, name), copy)
        written = (jax_plots.plot_metric_lines(copy)
                   + jax_plots.render_confusion_matrices(copy))
        return sorted(os.path.basename(p) for p in written)
    finally:
        shutil.rmtree(copy)


def rendered_names(metrics_dir_):
    return sorted(n for n in os.listdir(metrics_dir_)
                  if n.endswith((".png", ".svg")))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    ours = metrics_dir(str(root / "port"))
    theirs = metrics_dir(str(root / "jax"))
    return {"port": (plots.plot_metric_lines(ours),
                     plots.render_confusion_matrices(ours)),
            "jax": (jax_plots.plot_metric_lines(theirs),
                    jax_plots.render_confusion_matrices(theirs)),
            "dir": ours}


def test_both_packages_write_the_same_files(rendered):
    (png, svg), (jpng, jsvg) = rendered["port"], rendered["jax"]
    names = [os.path.basename(p) for p in png + svg]
    assert names == [os.path.basename(p) for p in jpng + jsvg]
    assert png == sorted(png) and svg == sorted(svg)
    assert names == ["fold3_train_loss.png", "train_loss.png",
                     "val_acc_distance.png", "val_acc_event.png",
                     "val_loss.png", "confusion_matrix_distance.svg",
                     "confusion_matrix_event.svg"]
    assert rendered_names(rendered["dir"]) == sorted(names)


def _chunks(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        out.append((kind, body))
        pos += 12 + n
    return out


@pytest.mark.parametrize("stem", ["fold3_train_loss", "train_loss",
                                  "val_acc_distance", "val_acc_event",
                                  "val_loss"])
def test_png_decodes_and_draws_every_value(stem, rendered):
    path = os.path.join(rendered["dir"], f"{stem}.png")
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (720, 480, 8, 2, 0, 0,
                                                       0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    assert (raw.reshape(480, 1 + 720 * 3)[:, 0] == 0).all()  # filter 0

    image = matplotlib.image.imread(path)
    assert image.shape == (480, 720, 3)
    values = np.load(os.path.join(rendered["dir"], f"{stem}.npy"))
    ax = plots.curve_axes(values)
    xs = np.rint(ax.x_px(np.arange(values.size))).astype(int)
    ys = np.rint(ax.y_px(values)).astype(int)
    is_line = np.isclose(image, LINE, atol=1e-6).all(-1)
    hits = np.array([is_line[y - 1:y + 2, x].any() for x, y in zip(xs, ys)])
    assert hits.all(), f"{(~hits).sum()} values of {values.size} undrawn"
    # The title, the labels and the ticks are drawn in black.
    title = plots.text_mask(stem.replace("_", " "))
    assert (image[:30] == 0).all(-1).sum() == title.sum()  # above the box
    assert (image == 0).all(-1).sum() > title.sum() + 200


def _svg(rendered, n):
    name = "confusion_matrix_distance" if n == 16 else \
        "confusion_matrix_event"
    root = ET.parse(os.path.join(rendered["dir"], f"{name}.svg")).getroot()
    cm = np.load(os.path.join(rendered["dir"], f"{name}.npy"))
    return root, cm, name


def _by_cell(root, tag, cls):
    out = {}
    for el in root.iter(SVG + tag):
        if el.get("class") == cls:
            out[int(el.get("data-row")), int(el.get("data-col"))] = el
    return out


@pytest.mark.parametrize("n", [16, 2])
def test_svg_counts_colours_and_labels(n, rendered):
    root, cm, name = _svg(rendered, n)
    assert cm.shape == (n, n)
    counts = _by_cell(root, "text", "count")
    cells = _by_cell(root, "rect", "cell")
    assert len(counts) == len(cells) == n * n
    norm = matplotlib.colors.Normalize(vmin=cm.min(), vmax=cm.max())
    blues = matplotlib.colormaps["Blues"]
    thresh = cm.max() / 2
    for (i, j), text in counts.items():
        assert text.text == str(int(cm[i, j]))
        assert text.get("fill") == ("#ffffff" if cm[i, j] > thresh
                                    else "#000000")
        fill = cells[i, j].get("fill")
        got = np.array([int(fill[k:k + 2], 16) for k in (1, 3, 5)]) / 255
        want = np.array(blues(norm(cm[i, j]))[:3])
        assert np.abs(got - want).max() <= 2 / 255, (i, j, fill)
    names = list(plots.class_names_for(n))
    for cls in ("xtick", "ytick"):
        ticks = sorted((int(el.get("data-index")), el.text)
                       for el in root.iter(SVG + "text")
                       if el.get("class") == cls)
        assert [t for _, t in ticks] == names
    texts = {el.get("class"): el.text for el in root.iter(SVG + "text")}
    assert texts["xlabel"] == "Predicted label"
    assert texts["ylabel"] == "True label"
    assert texts["title"] == name.replace("_", " ")
    assert any(el.get("class") == "colorbar" for el in root.iter(SVG + "rect"))
    if n == 2:  # all zeros: every count black, every cell the lightest blue
        assert {c.get("fill") for c in cells.values()} == {"#f7fbff"}


def test_blues_is_matplotlib_s_at_every_level():
    values = np.arange(-3, 300)
    got = plots.blues_rgb(values)
    norm = matplotlib.colors.Normalize(vmin=values.min(), vmax=values.max())
    want = matplotlib.colormaps["Blues"](norm(values))[:, :3]
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_ticks_and_labels():
    assert plots.nice_ticks(0.0, 1.0) == (0.2, pytest.approx(
        [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]))
    step, ticks = plots.nice_ticks(-0.05, 1.05)
    assert step == 0.2 and ticks[0] == 0.0
    assert plots.tick_label(0.25, 0.25) == "0.25"
    assert plots.tick_label(-1e-17, 0.2) == "0"
    assert plots.tick_label(40000.0, 20000.0) == "40000"
    assert plots.tick_label(2.5, 2.5) == "2.5"
    assert plots.tick_label(75.0, 25.0) == "75"
    assert plots.text_mask("step").shape == (14, 48)
    assert plots.text_mask("é").sum() == plots.text_mask("?").sum()
