"""Draw — residual line graphs (-ksp_monitor_draw analog).

Counterpart of petsctpu/core/draw.py: the same text, from the same
numbers.

Reference: src/sys/classes/draw (X11/OpenGL/TikZ line graphs fed by
KSPMonitorLG). A headless machine has no X11; the equivalents here are
an ASCII line graph rendered to the terminal and an optional
matplotlib PNG (where matplotlib is installed) — both consuming the
residual history that every SolveResult already carries, so "drawing"
is pure post-processing on the host.
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    """A numpy array of a host array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _finite_history(history) -> np.ndarray:
    h = np.asarray(_host(history), float)
    return h[np.isfinite(h)]


def ascii_lg(history, width: int = 60, height: int = 16,
             title: str = "Residual norm (log10)") -> str:
    """Render a log-scale line graph of a residual history as text."""
    h = _finite_history(history)
    if h.size == 0:
        return "(no residual history)"
    h = np.maximum(h, 1e-300)
    logs = np.log10(h)
    lo, hi = float(logs.min()), float(logs.max())
    if hi - lo < 1e-12:
        hi = lo + 1.0
    cols = np.linspace(0, len(logs) - 1, min(width, len(logs))).astype(int)
    vals = logs[cols]
    rows = []
    for r in range(height):
        level = hi - (r / (height - 1)) * (hi - lo)
        line = []
        for v in vals:
            line.append("*" if abs(v - level) <= (hi - lo) / (2 * (height - 1))
                        else ("." if v > level else " "))
        label = f"{level:6.1f} |"
        rows.append(label + "".join(line))
    footer = " " * 8 + "0" + " " * (len(cols) - 2) + str(len(logs) - 1)
    return "\n".join([title] + rows + [footer,
                     f"  its={len(h) - 1}  r0={h[0]:.3e}  "
                     f"r={h[-1]:.3e}"])


def save_lg_png(history, path: str, title: str = "KSP residual") -> bool:
    """Write a matplotlib semilogy of the history; returns False when
    matplotlib is unavailable (gated dependency)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    h = _finite_history(history)
    if h.size == 0:
        return False
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(np.arange(len(h)), np.maximum(h, 1e-300), "o-", ms=3)
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual norm")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def monitor_draw(result, save: str = None, echo: bool = True) -> str:
    """KSPMonitorLG analog driven from a SolveResult/SNESResult."""
    txt = ascii_lg(result.history)
    if echo:
        print(txt)
    if save:
        save_lg_png(result.history, save)
    return txt


def ascii_contour(grid, width: int = 64, height: int = 24,
                  chars: str = " .:-=+*#%@") -> str:
    """ASCII contour map of a 2-D grid array (the VecView draw-contour
    analog, src/sys/classes/draw contour plots): values binned into
    density characters after bilinear resampling to the terminal box."""
    G = np.asarray(_host(grid), float)
    if G.ndim == 1:
        n = int(np.sqrt(G.size))
        G = G.reshape(n, -1)
    ys = np.linspace(0, G.shape[0] - 1, height)
    xs = np.linspace(0, G.shape[1] - 1, width)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = ys - yi, xs - xi
    yi1 = np.minimum(yi + 1, G.shape[0] - 1)
    xi1 = np.minimum(xi + 1, G.shape[1] - 1)
    R = ((1 - yf)[:, None] * ((1 - xf) * G[yi][:, xi] + xf * G[yi][:, xi1])
         + yf[:, None] * ((1 - xf) * G[yi1][:, xi] + xf * G[yi1][:, xi1]))
    lo, hi = R.min(), R.max()
    t = (R - lo) / (hi - lo) if hi > lo else R * 0
    idx = np.minimum((t * len(chars)).astype(int), len(chars) - 1)
    lines = ["".join(chars[k] for k in row) for row in idx[::-1]]
    lines.append(f"min={lo:.4g} max={hi:.4g}")
    return "\n".join(lines)
