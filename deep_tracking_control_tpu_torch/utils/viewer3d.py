"""3D gait viewer — the full-scene analog of the Isaac Gym viewer.

The reference's live verification surface draws the robot body over the
terrain triangle mesh with foothold debug spheres in an interactive GL
viewer (base_task.py:130-190 viewer lifecycle, legged_robot_dtc.py:460-520
_draw_debug_vis).  TPU hosts are headless; this renders the same scene —
terrain surface, articulated robot skeleton posed by forward kinematics
from the recorded (pos, quat, q) trajectory, torso box, feet, and the
nominal/optimal foothold markers — with matplotlib's 3D backend, either
as an animated GIF (``render_3d_animation``) or as an interactive window
when a display is present (``show_interactive``; mouse-drag orbits, same
role as the Isaac viewer camera).

Pure numpy (its own tiny FK mirror of physics/engine.py:111-146) so it
imports without jax and renders recorded trajectories anywhere.
"""
from __future__ import annotations

import numpy as np

# color convention shared with utils/debug_viz.py / render_anim.py:
# feet black, nominal (predicted) footholds cyan, optimal footholds magenta
_C_FOOT = "#222222"
_C_NOMINAL = "#00b7c7"
_C_OPTIMAL = "#c701a0"
_C_LINK = "#1f77b4"
_C_TORSO = "#27374d"


def _axis_rot(axis: np.ndarray, th: float) -> np.ndarray:
    a = np.asarray(axis, dtype=np.float64)
    c, s = np.cos(th), np.sin(th)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return c * np.eye(3) + s * K + (1.0 - c) * np.outer(a, a)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> body->world rotation (ops/quat.py:88 mirror)."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def fk_positions(model, pos, quat, q):
    """World origin + orientation of every dynamic body for ONE sample.

    numpy mirror of physics/engine.py:111-146 fk() (position part only).
    Returns (x (nb, 3), R (nb, 3, 3))."""
    nb = model.nb
    x = np.zeros((nb, 3))
    R = np.zeros((nb, 3, 3))
    x[0] = pos
    R[0] = _quat_to_mat(np.asarray(quat, dtype=np.float64))
    for i in range(1, nb):
        j, p = i - 1, int(model.parent[i])
        R_pc = model.joint_R[j] @ _axis_rot(model.joint_axis[j], float(q[j]))
        x[i] = x[p] + R[p] @ model.joint_t[j]
        R[i] = R[p] @ R_pc
    return x, R


def foot_positions_from_fk(model, x, R):
    """World positions of the welded feet (foot_dyn_index + foot_offset)."""
    out = np.zeros((len(model.foot_dyn_index), 3))
    for f, (di, off) in enumerate(zip(model.foot_dyn_index,
                                      model.foot_offset)):
        out[f] = x[int(di)] + R[int(di)] @ off
    return out


def _torso_box(model):
    """Torso wireframe dims derived from the hip attachment points: the
    box spans the hip origins plus a small margin (no collision geometry
    in RobotModel — this is a visual body, like the viewer's URDF visual)."""
    t = np.abs(model.joint_t[np.asarray(model.parent[1:]) == 0])
    hx = float(t[:, 0].max()) + 0.06
    hy = float(t[:, 1].max()) + 0.05
    hz = 0.045 + 0.01 * (model.mass[0] > 20.0)  # chunkier box for X30
    corners = np.array([[sx * hx, sy * hy, sz * hz]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return corners, edges


def _terrain_patch(heightfield, horizontal_scale, border_size, bx, by,
                   window, max_quads=42):
    """(X, Y, Z) surface patch around (bx, by), downsampled for drawing."""
    hf = np.asarray(heightfield)
    r0 = int(round((bx - window + border_size) / horizontal_scale))
    c0 = int(round((by - window + border_size) / horizontal_scale))
    n = int(round(2 * window / horizontal_scale))
    r0 = max(0, min(hf.shape[0] - n, r0))
    c0 = max(0, min(hf.shape[1] - n, c0))
    stride = max(1, n // max_quads)
    patch = hf[r0:r0 + n:stride, c0:c0 + n:stride]
    xs = (r0 + stride * np.arange(patch.shape[0])) * horizontal_scale \
        - border_size
    ys = (c0 + stride * np.arange(patch.shape[1])) * horizontal_scale \
        - border_size
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    return X, Y, patch


def _draw_scene(ax, model, heightfield, horizontal_scale, border_size,
                frame, window, corners, edges):
    # draw in call order: mplot3d's depth sort occludes thin lines behind
    # large surfaces wholesale — terrain first, robot on top
    ax.computed_zorder = False
    pos = np.asarray(frame["base_pos"], dtype=np.float64)
    x, R = fk_positions(model, pos, frame["base_quat"], frame["q"])
    feet = frame.get("foot_positions")
    feet = (np.asarray(feet) if feet is not None
            else foot_positions_from_fk(model, x, R))

    X, Y, Z = _terrain_patch(heightfield, horizontal_scale, border_size,
                             pos[0], pos[1], window)
    # z-window follows the ROBOT, not the terrain extremes: stepping-stone
    # worlds have multi-meter pits that would shrink the robot to a speck
    zlo = pos[2] - 0.85
    zhi = pos[2] + 0.45
    Z = np.clip(Z, zlo, zhi)
    ax.plot_surface(X, Y, Z, cmap="Greys", linewidth=0.2,
                    edgecolor="#bbbbbb", alpha=0.55, antialiased=False,
                    vmin=zlo - 0.3 * (zhi - zlo), vmax=zhi,
                    rcount=Z.shape[0], ccount=Z.shape[1])

    # skeleton: one segment per revolute joint (parent origin -> child
    # origin), thicker near the torso
    for i in range(1, model.nb):
        p = int(model.parent[i])
        lw = 3.5 if p == 0 else 2.5
        ax.plot(*zip(x[p], x[i]), color=_C_LINK, lw=lw, solid_capstyle="round")
    # shank -> foot segment for the welded feet
    for f, (di, off) in enumerate(zip(model.foot_dyn_index,
                                      model.foot_offset)):
        tip = x[int(di)] + R[int(di)] @ off
        ax.plot(*zip(x[int(di)], tip), color=_C_LINK, lw=2.0)

    # torso wireframe box
    world = (R[0] @ corners.T).T + pos
    for a, b in edges:
        ax.plot(*zip(world[a], world[b]), color=_C_TORSO, lw=1.4)
    ax.scatter(feet[:, 0], feet[:, 1], feet[:, 2], color=_C_FOOT, s=26,
               depthshade=False)

    nom = frame.get("pred_footholds")
    if nom is not None:
        nom = np.asarray(nom)
        ax.scatter(nom[:, 0], nom[:, 1], nom[:, 2] + 0.01, color=_C_NOMINAL,
                   s=34, marker="o", alpha=0.9, depthshade=False,
                   label="nominal foothold")
    opt = frame.get("optimal_footholds")
    if opt is not None:
        opt = np.asarray(opt)
        ax.scatter(opt[:, 0], opt[:, 1], opt[:, 2] + 0.01, color=_C_OPTIMAL,
                   s=44, marker="*", alpha=0.95, depthshade=False,
                   label="optimal foothold")

    ax.set_xlim(pos[0] - window, pos[0] + window)
    ax.set_ylim(pos[1] - window, pos[1] + window)
    ax.set_zlim(zlo, zhi)
    ax.set_box_aspect((2 * window, 2 * window, zhi - zlo))
    cmd = frame.get("commands")
    if cmd is not None:
        ax.set_title(f"cmd=({cmd[0]:+.2f}, {cmd[1]:+.2f}) m/s  "
                     f"z={pos[2]:+.2f} m", fontsize=9)
    ax.tick_params(labelsize=6)


def render_3d_animation(path, heightfield, horizontal_scale, border_size,
                        model, frames, fps=12, stride=2, window=0.85,
                        elev=24.0, azim=-55.0, orbit=0.35,
                        title="DTC 3D gait"):
    """Write an animated GIF of the 3D scene for a recorded trajectory.

    frames: sequence of dicts with base_pos (3,), base_quat (4, xyzw),
    q (nq,), and optionally foot_positions/pred_footholds/
    optimal_footholds (4, 3) and commands.  ``orbit`` adds a slow camera
    azimuth drift per frame, standing in for the viewer's orbit camera."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    corners, edges = _torso_box(model)
    images = []
    fig = plt.figure(figsize=(5.4, 4.4), dpi=96)
    for fi, frame in enumerate(frames[::stride]):
        fig.clf()
        ax = fig.add_subplot(111, projection="3d")
        ax.view_init(elev=elev, azim=azim + orbit * fi)
        _draw_scene(ax, model, heightfield, horizontal_scale, border_size,
                    frame, window, corners, edges)
        fig.suptitle(title, fontsize=10)
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        images.append(Image.fromarray(buf.copy()))
    plt.close(fig)
    if not images:
        raise ValueError("no frames to render")
    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0, optimize=True)
    return path


def show_interactive(heightfield, horizontal_scale, border_size, model,
                     frame, window=1.2):
    """Open an interactive 3D window for one frame (requires a display;
    mouse-drag orbits the camera — the Isaac viewer interaction analog)."""
    import matplotlib.pyplot as plt

    corners, edges = _torso_box(model)
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    _draw_scene(ax, model, heightfield, horizontal_scale, border_size,
                frame, window, corners, edges)
    plt.show()
    return fig
