"""Debug visualization — headless analog of the viewer foothold drawing.

The reference draws wireframe spheres in the Isaac viewer for the scan
points, foothold scores, nominal and optimal footholds
(legged_robot_dtc.py:460-520 _draw_debug_vis).  TPU pods have no viewer;
this renders the same information for one env to a PNG: local heightfield,
scored scan points, predicted (nominal) footholds, selected optimal
footholds, and the current feet.
"""
from __future__ import annotations

import numpy as np


def draw_foothold_debug(path, heightfield, horizontal_scale, border_size,
                        base_pos, heights_world, foothold_score,
                        pred_footholds, optimal_footholds, foot_positions,
                        window: float = 2.0):
    """Save a top-down debug frame for one env.

    heightfield (R,C) meters; *_world quantities for ONE env (H,3)/(4,3);
    foothold_score (H,4) combined score (planner output)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bx, by = float(base_pos[0]), float(base_pos[1])
    r0 = int((bx - window + border_size) / horizontal_scale)
    c0 = int((by - window + border_size) / horizontal_scale)
    n = int(2 * window / horizontal_scale)
    R, C = heightfield.shape
    r0 = np.clip(r0, 0, max(R - n, 0))
    c0 = np.clip(c0, 0, max(C - n, 0))
    patch = np.asarray(heightfield[r0:r0 + n, c0:c0 + n])
    extent = [c0 * horizontal_scale - border_size,
              (c0 + n) * horizontal_scale - border_size,
              r0 * horizontal_scale - border_size,
              (r0 + n) * horizontal_scale - border_size]

    fig, ax = plt.subplots(figsize=(7, 7))
    im = ax.imshow(patch, origin="lower", extent=extent, cmap="terrain")
    fig.colorbar(im, ax=ax, label="height [m]", shrink=0.8)

    score = np.min(np.asarray(foothold_score), axis=1)        # (H,)
    hw = np.asarray(heights_world)
    bad = (score > 0.9) & (score < 8.0)                       # dtc.py:486
    ax.scatter(hw[bad, 1], hw[bad, 0], s=6, c="red", label="high cost")
    ax.scatter(np.asarray(pred_footholds)[:, 1],
               np.asarray(pred_footholds)[:, 0], s=60, marker="x",
               c="yellow", label="nominal foothold")
    ax.scatter(np.asarray(optimal_footholds)[:, 1],
               np.asarray(optimal_footholds)[:, 0], s=60, marker="o",
               facecolors="none", edgecolors="lime", linewidths=2,
               label="optimal foothold")
    ax.scatter(np.asarray(foot_positions)[:, 1],
               np.asarray(foot_positions)[:, 0], s=40, marker="^",
               c="blue", label="feet")
    ax.scatter([by], [bx], s=100, marker="*", c="white", label="base")
    ax.set_xlabel("y [m]")
    ax.set_ylabel("x [m]")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("DTC foothold debug")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
