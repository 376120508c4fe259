"""Headless gait animation — the viewer replacement.

The reference's only live verification surface is the Isaac Gym viewer
with foothold debug spheres (base_task.py:130-190 viewer lifecycle,
legged_robot_dtc.py:460-520 _draw_debug_vis).  TPU hosts have no viewer;
this renders the same content as an animated GIF from a recorded eval
trajectory: top-down heightfield with the base track, feet, nominal and
optimal footholds, plus a side panel of base height over terrain.

Usage: scripts/play.py --render collects frames for env 0 and calls
render_gait_animation.
"""
from __future__ import annotations

import numpy as np


def _fig_to_rgb(fig):
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def render_gait_animation(path, heightfield, horizontal_scale, border_size,
                          frames, fps=12, window=2.5, stride=1,
                          title="DTC gait"):
    """Write an animated GIF of a recorded trajectory for one env.

    heightfield: (R, C) terrain heights in meters (world x is rows).
    frames: sequence of dicts with keys
        base_pos (3,), foot_positions (4,3), pred_footholds (4,3),
        optimal_footholds (4,3), commands (>=2,), base_vel (>=2,)
    (all world-frame numpy arrays; commands/base_vel in m/s).
    Returns the written path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    hf = np.asarray(heightfield)
    R, C = hf.shape
    frames = frames[::stride]
    base = np.stack([np.asarray(f["base_pos"]) for f in frames])   # (T, 3)

    # one static crop covering the whole base track (+ window margin)
    lo = base[:, :2].min(axis=0) - window
    hi = base[:, :2].max(axis=0) + window
    r0 = int(np.clip((lo[0] + border_size) / horizontal_scale, 0, R - 2))
    r1 = int(np.clip((hi[0] + border_size) / horizontal_scale + 1, r0 + 1, R))
    c0 = int(np.clip((lo[1] + border_size) / horizontal_scale, 0, C - 2))
    c1 = int(np.clip((hi[1] + border_size) / horizontal_scale + 1, c0 + 1, C))
    patch = hf[r0:r1, c0:c1]
    extent = [c0 * horizontal_scale - border_size,
              c1 * horizontal_scale - border_size,
              r0 * horizontal_scale - border_size,
              r1 * horizontal_scale - border_size]

    fig, (ax, axz) = plt.subplots(
        2, 1, figsize=(7, 9), gridspec_kw={"height_ratios": [4, 1]})
    im = ax.imshow(patch, origin="lower", extent=extent, cmap="terrain")
    fig.colorbar(im, ax=ax, label="terrain height [m]", shrink=0.8)
    ax.set_xlabel("y [m]")
    ax.set_ylabel("x [m]")

    (track,) = ax.plot([], [], "-", c="white", lw=1.2, alpha=0.8,
                       label="base track")
    feet = ax.scatter([], [], s=45, marker="^", c="blue", label="feet")
    pred = ax.scatter([], [], s=70, marker="x", c="yellow",
                      label="nominal foothold")
    opt = ax.scatter([], [], s=70, marker="o", facecolors="none",
                     edgecolors="lime", linewidths=2,
                     label="optimal foothold")
    star = ax.scatter([], [], s=130, marker="*", c="white", label="base")
    arrow = [None]
    ax.legend(loc="upper right", fontsize=8)

    # side panel: base z and terrain z under the base, over time
    t = np.arange(len(frames))
    terr_z = []
    for f in frames:
        rr = int(np.clip((f["base_pos"][0] + border_size) / horizontal_scale,
                         0, R - 1))
        cc = int(np.clip((f["base_pos"][1] + border_size) / horizontal_scale,
                         0, C - 1))
        terr_z.append(hf[rr, cc])
    terr_z = np.asarray(terr_z)
    axz.plot(t, base[:, 2], c="tab:blue", label="base z")
    axz.plot(t, terr_z, c="tab:brown", label="terrain z")
    cursor = axz.axvline(0, c="red", lw=1)
    axz.set_xlabel("frame")
    axz.set_ylabel("z [m]")
    axz.legend(loc="upper right", fontsize=8)

    images = []
    for i, f in enumerate(frames):
        track.set_data(base[:i + 1, 1], base[:i + 1, 0])
        fp = np.asarray(f["foot_positions"])
        feet.set_offsets(fp[:, [1, 0]])
        pf = np.asarray(f["pred_footholds"])
        pred.set_offsets(pf[:, [1, 0]])
        of = np.asarray(f["optimal_footholds"])
        opt.set_offsets(of[:, [1, 0]])
        star.set_offsets([[base[i, 1], base[i, 0]]])
        if arrow[0] is not None:
            arrow[0].remove()
        cmd = np.asarray(f["commands"])
        arrow[0] = ax.arrow(base[i, 1], base[i, 0],
                            float(cmd[1]) * 0.5, float(cmd[0]) * 0.5,
                            head_width=0.08, color="red")
        vel = np.asarray(f["base_vel"])
        ax.set_title(f"{title} — frame {i}  "
                     f"cmd=({cmd[0]:+.2f},{cmd[1]:+.2f}) m/s  "
                     f"vel=({vel[0]:+.2f},{vel[1]:+.2f}) m/s")
        cursor.set_xdata([i, i])
        images.append(Image.fromarray(_fig_to_rgb(fig)))
    plt.close(fig)

    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0)
    return path
