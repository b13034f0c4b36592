"""What a drawing function plots, recorded at each save, for the tests that
hold the port's drawing functions to the JAX package's.

``recording(root)`` replaces ``matplotlib.pyplot.savefig`` and ``show``
(both packages call them through ``matplotlib.pyplot``) and records, under
the file name relative to ``root`` (shows as ``<show N>``), each axes'
limits and scales, each line's xy data, each patch's geometry (a
rectangle's x, y, width and height; another patch's vertices), each
collection's segments or offsets, and its texts (title, axis labels,
legend entries, annotations) with the numbers taken out.  With
``write=False`` the file is created empty instead of rendered.

``assert_same_structure`` compares two recordings' files, axes, artists
and texts (the same once the numbers are out, each number within one unit
of the last digit printed); ``assert_same_plots`` also every array, within
the given bars.  ``roc_from(port_roc)`` makes the JAX package's ROC
sweep hand on the port's rates after holding its own to them at
``tests/test_torch_roc.py``'s bars, so that what is drawn from a ROC
compares at the plots' bars downstream.  ``jax_eval_noise`` is the JAX
CLI's latent draw in ``_evaluate``, for the port's ``_eval_noise``.
"""

import contextlib
import os
import re

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROC_ATOL = 1e-6                 # tests/test_torch_roc.py: rates, thresholds exact
_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _texts(ax):
    texts = [ax.get_title(), ax.get_xlabel(), ax.get_ylabel()]
    texts += [t.get_text() for t in ax.texts]
    legend = ax.get_legend()
    if legend is not None:
        texts += [t.get_text() for t in legend.get_texts()]
    return [(_NUMBER.sub("#", t), _NUMBER.findall(t)) for t in texts]


def _patch(p):
    if isinstance(p, Rectangle):
        return np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()], np.float64)
    xy = p.get_xy() if hasattr(p, "get_xy") else p.get_path().vertices
    return np.asarray(xy, np.float64)


def _collection(c):
    if hasattr(c, "get_segments"):
        segs = c.get_segments()
        return np.concatenate(segs).astype(np.float64) if segs else np.zeros((0, 2))
    return np.asarray(c.get_offsets(), np.float64)


def record_figure(fig):
    out = []
    for ax in fig.axes:
        out.append({
            "xlim": np.asarray(ax.get_xlim(), np.float64),
            "ylim": np.asarray(ax.get_ylim(), np.float64),
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "lines": [np.asarray(line.get_xydata(), np.float64) for line in ax.lines],
            "patches": [_patch(p) for p in ax.patches],
            "collections": [_collection(c) for c in ax.collections],
            "texts": _texts(ax),
        })
    return out


@contextlib.contextmanager
def recording(root, write=False):
    """Yields {file name relative to root: record} filled at each save."""
    records = {}
    real_savefig, real_show = plt.savefig, plt.show

    def savefig(fname, *args, **kwargs):
        name = os.path.relpath(str(fname), str(root))
        assert name not in records, f"{name} saved twice"
        records[name] = record_figure(plt.gcf())
        if write:
            real_savefig(fname, *args, **kwargs)
        else:
            open(fname, "wb").close()

    def show(*args, **kwargs):
        records[f"<show {sum(k.startswith('<show') for k in records)}>"] = \
            record_figure(plt.gcf())
        plt.close(plt.gcf())

    plt.savefig, plt.show = savefig, show
    try:
        yield records
    finally:
        plt.savefig, plt.show = real_savefig, real_show


def _close(got, want, what, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    bad = ~same & ~(np.abs(got - want) <= atol + rtol * np.abs(want))
    if bad.any():
        at = np.unravel_index(int(np.argmax(bad)), got.shape)
        raise AssertionError(f"{what}: {int(bad.sum())} of {got.size} over atol {atol} + "
                             f"rtol {rtol}; first at {tuple(int(i) for i in at)}: got "
                             f"{got[at]!r}, want {want[at]!r}")


def _same_number(got, want, what):
    """Two printed numbers within one unit of the last digit printed."""
    if got == want:
        return
    mantissa = want.lower().split("e")[0]
    exp = int(want.lower().split("e")[1]) if "e" in want.lower() else 0
    places = len(mantissa.split(".")[1]) if "." in mantissa else 0
    assert "." in mantissa and abs(float(got) - float(want)) <= 10.0 ** (exp - places) * 1.0001, \
        f"{what}: printed {got} against {want}"


def assert_same_structure(got, want):
    """What two recordings share where their inputs differ by rounding: the
    files, and per axes the scales, the texts (each number within one unit
    of the last digit printed) and the number of lines, patches and
    collections."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]) == len(want[name]), f"{name}: axes"
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            what = f"{name} axes {i}"
            assert g["scales"] == w["scales"], what
            _same_texts(g["texts"], w["texts"], what)
            for key in ("lines", "patches", "collections"):
                assert len(g[key]) == len(w[key]), f"{what} {key}: {len(g[key])} != {len(w[key])}"


def _same_texts(got, want, what):
    assert [t for t, _ in got] == [t for t, _ in want], what
    for (text, gn), (_, wn) in zip(got, want):
        assert len(gn) == len(wn), f"{what} text {text!r}"
        for x, y in zip(gn, wn):
            _same_number(x, y, f"{what} text {text!r}")


def assert_same_plots(got, want, rtol=RTOL, atol=ATOL, bars=None):
    """``bars``: {file name: (rtol, atol)} where a file's arrays are held to
    another test's bar."""
    assert_same_structure(got, want)
    for name in want:
        r, a = (bars or {}).get(name, (rtol, atol))
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            what = f"{name} axes {i}"
            for key in ("xlim", "ylim"):
                _close(g[key], w[key], f"{what} {key}", r, a)
            for key in ("lines", "patches", "collections"):
                for j, (x, y) in enumerate(zip(g[key], w[key])):
                    _close(x, y, f"{what} {key}[{j}]", r, a)


def roc_from(monkeypatch, port_roc, jax_roc):
    """Replace ``jax_roc.roc_rates`` (every ROC of the JAX package goes
    through it) by one that computes its own rates, holds them to the
    port's on the same inputs (rates within ROC_ATOL, thresholds equal) and
    returns the port's.  Returns the list of (port, jax) rate triples."""
    real = jax_roc.roc_rates
    seen = []

    def roc_rates(y_true, scores, weights=None):
        want = real(y_true, scores, weights)
        got = port_roc.roc_rates(y_true, scores, weights, device="cpu")
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"roc_rates[{k}]", 0.0, ROC_ATOL if k < 2 else 0.0)
        seen.append((got, want))
        return got

    monkeypatch.setattr(jax_roc, "roc_rates", roc_rates)
    return seen


def jax_eval_noise(n, start, shape, device, generator):
    """The JAX CLI's threefry draw for evaluation pass n's chunk at row
    start (``atlasvae/cli/vae.py:_evaluate``), as a tensor on ``device``."""
    import jax
    import torch
    key = jax.random.fold_in(jax.random.PRNGKey(n), start)
    return torch.tensor(np.asarray(jax.random.normal(key, shape)), device=device)
