r"""Matplotlib house style for publication plots.

A copy of ``dair_pll_tpu/plot_styler.py`` (``matplotlib`` is imported
inside the functions). Rebuild of the reference's ``plot_styler.py``
(``/root/reference/dair_pll/plot_styler.py:14-56``): a consistent
typography/color/grid style applied globally, plus figure save helpers.
"""
from __future__ import annotations

import os
FIGURE_DPI = 300

COLORS = ["#01256e", "#398537", "#95001a", "#9e6402", "#4a0042",
          "#016367"]


def set_default_styling(font_size: int = 16,
                        use_tex: bool = False) -> None:
    """Applies the house style to matplotlib's rcParams."""
    import matplotlib
    matplotlib.use("Agg")
    from cycler import cycler
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "figure.dpi": FIGURE_DPI,
        "font.size": font_size,
        "axes.titlesize": font_size,
        "axes.labelsize": font_size,
        "legend.fontsize": font_size - 2,
        "xtick.labelsize": font_size - 2,
        "ytick.labelsize": font_size - 2,
        "axes.prop_cycle": cycler(color=COLORS),
        "axes.grid": True,
        "grid.alpha": 0.3,
        "lines.linewidth": 2.0,
        "text.usetex": use_tex,
        "savefig.bbox": "tight",
    })


def save_figure(figure, directory: str, name: str) -> str:
    """Saves a figure as png under a directory; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.png")
    figure.savefig(path)
    return path
