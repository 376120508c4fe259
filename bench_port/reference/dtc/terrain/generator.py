"""Procedural terrain generation (host-side numpy, init time).

Capability parity with legged_gym/utils/terrain.py (Terrain class,
curriculum/randomized/selected layouts, terrain.py:8-160) plus the five
isaacgym.terrain_utils generators it calls (pyramid_sloped, random_uniform,
pyramid_stairs, discrete_obstacles, stepping_stones — terrain.py:116-139)
and the three local generators (gap :162, pit :175, stones_everywhere :185).
All generators are reimplemented from their semantics on an int16 height
grid; randomness is threaded through a numpy Generator for determinism
(the reference uses global np.random).

The output feeds TerrainGrid (device heightfield) directly — no trimesh
conversion (see terrain/grid.py docstring).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SubTerrain:
    """One tile's height grid in cells (terrain_utils.SubTerrain analog)."""
    width: int            # cells along x
    length: int           # cells along y
    vertical_scale: float
    horizontal_scale: float

    def __post_init__(self):
        self.height_field_raw = np.zeros((self.width, self.length), dtype=np.int16)


# --- tile generators -------------------------------------------------------

def random_uniform_terrain(t: SubTerrain, rng, min_height, max_height, step,
                           downsampled_scale=0.2):
    """Uniform random bumps sampled on a coarse grid, upsampled by nearest
    interpolation (terrain_utils semantics used at terrain.py:122)."""
    h_min = int(min_height / t.vertical_scale)
    h_max = int(max_height / t.vertical_scale)
    h_step = max(int(step / t.vertical_scale), 1)
    heights_range = np.arange(h_min, h_max + h_step, h_step)
    down = max(int(downsampled_scale / t.horizontal_scale), 1)
    nw = t.width // down + 2
    nl = t.length // down + 2
    coarse = rng.choice(heights_range, (nw, nl))
    up = np.repeat(np.repeat(coarse, down, axis=0), down, axis=1)
    t.height_field_raw += up[:t.width, :t.length].astype(np.int16)
    return t


def pyramid_sloped_terrain(t: SubTerrain, rng, slope, platform_size=1.0):
    """Pyramid with given slope and a flat center platform."""
    x = np.arange(t.width)
    y = np.arange(t.length)
    cx, cy = t.width / 2, t.length / 2
    dist = np.maximum(np.abs(x[:, None] - cx) / cx, np.abs(y[None, :] - cy) / cy)
    max_h = slope * (t.width / 2) * t.horizontal_scale / t.vertical_scale
    hf = (max_h * (1.0 - dist)).astype(np.int16)
    plat = int(platform_size / t.horizontal_scale / 2)
    x1, x2 = int(cx) - plat, int(cx) + plat
    y1, y2 = int(cy) - plat, int(cy) + plat
    center_h = hf[int(cx), int(cy)]
    hf[x1:x2, y1:y2] = center_h
    t.height_field_raw += hf
    return t


def pyramid_stairs_terrain(t: SubTerrain, rng, step_width, step_height,
                           platform_size=1.0):
    """Concentric rectangular steps toward the center."""
    sw = max(int(step_width / t.horizontal_scale), 1)
    sh = int(step_height / t.vertical_scale)
    plat = int(platform_size / t.horizontal_scale)
    height = 0
    x1, x2 = 0, t.width
    y1, y2 = 0, t.length
    while (x2 - x1) > plat and (y2 - y1) > plat:
        x1 += sw; x2 -= sw; y1 += sw; y2 -= sw
        height += sh
        t.height_field_raw[x1:x2, y1:y2] = height
    return t


def discrete_obstacles_terrain(t: SubTerrain, rng, max_height, min_size,
                               max_size, num_rects, platform_size=1.0):
    """Random rectangles at +-{h, h/2, h/4} heights; flat center platform."""
    h = int(max_height / t.vertical_scale)
    mn = int(min_size / t.horizontal_scale)
    mx = int(max_size / t.horizontal_scale)
    heights = [-h, -h // 2, -h // 4, h // 4, h // 2, h]
    for _ in range(num_rects):
        w = int(rng.integers(mn, max(mx, mn + 1)))
        l = int(rng.integers(mn, max(mx, mn + 1)))
        sx = int(rng.integers(0, max(t.width - w, 1)))
        sy = int(rng.integers(0, max(t.length - l, 1)))
        t.height_field_raw[sx:sx + w, sy:sy + l] = int(rng.choice(heights))
    plat = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - plat:cx + plat, cy - plat:cy + plat] = 0
    return t


def stepping_stones_terrain(t: SubTerrain, rng, stone_size, stone_distance,
                            max_height, platform_size=1.0, depth=-10.0):
    """Grid of stones separated by deep holes (the DTC headline terrain)."""
    ss = max(int(stone_size / t.horizontal_scale), 1)
    sd = int(stone_distance / t.horizontal_scale)
    hmax = int(max_height / t.vertical_scale)
    heights = np.arange(-hmax - 1, hmax + 1)
    t.height_field_raw[:, :] = int(depth / t.vertical_scale)
    start_y = 0
    while start_y < t.length:
        stop_y = min(t.length, start_y + ss)
        start_x = int(rng.integers(0, ss))
        # fill first hole
        stop_x = max(0, start_x - sd)
        t.height_field_raw[0:stop_x, start_y:stop_y] = int(rng.choice(heights))
        while start_x < t.width:
            stop_x = min(t.width, start_x + ss)
            t.height_field_raw[start_x:stop_x, start_y:stop_y] = int(rng.choice(heights))
            start_x += ss + sd
        start_y += ss + sd
    plat = int(platform_size / t.horizontal_scale / 2)
    cx, cy = t.width // 2, t.length // 2
    t.height_field_raw[cx - plat:cx + plat, cy - plat:cy + plat] = 0
    return t


def gap_terrain(t: SubTerrain, rng, gap_size, platform_size=1.0):
    """Ring gap around a center platform (terrain.py:162-173)."""
    gap = int(gap_size / t.horizontal_scale)
    plat = int(platform_size / t.horizontal_scale)
    cx, cy = t.width // 2, t.length // 2
    x1 = (t.width - plat) // 2
    x2 = x1 + gap
    y1 = (t.length - plat) // 2
    y2 = y1 + gap
    t.height_field_raw[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    t.height_field_raw[cx - x1:cx + x1, cy - y1:cy + y1] = 0
    return t


def pit_terrain(t: SubTerrain, rng, depth, platform_size=1.0):
    """Sunken center platform (terrain.py:175-182)."""
    d = int(depth / t.vertical_scale)
    plat = int(platform_size / t.horizontal_scale / 2)
    x1, x2 = t.width // 2 - plat, t.width // 2 + plat
    y1, y2 = t.length // 2 - plat, t.length // 2 + plat
    t.height_field_raw[x1:x2, y1:y2] = -d
    return t


def stones_everywhere_terrain(t: SubTerrain, rng, stone_size, stone_distance,
                              max_height, platform_size=1.0, depth=-2.0):
    """Randomized-size stones covering the whole tile (terrain.py:185-243)."""
    max_ss = max(int(stone_size / t.horizontal_scale), 2)
    sizes = np.arange(max_ss - 1, max_ss + 1)
    sd = max(int(stone_distance / t.horizontal_scale), 1)
    dists = np.arange(sd, sd + 1)
    hmax = max(int(max_height / t.vertical_scale), 1)
    heights = np.arange(1, 2 * hmax + 1)
    t.height_field_raw[:, :] = int(depth / t.vertical_scale)
    if t.length >= t.width:
        # row-major fill (terrain.py:211-222); ties go here, like the
        # reference's `length >= width` branch — all shipped configs use
        # square 8x8 m tiles and always take this path
        start_y = 0
        while start_y < t.length:
            stop_y = min(t.length, start_y + int(rng.choice(sizes)))
            start_x = int(rng.integers(0, int(rng.choice(sizes))))
            stop_x = max(0, start_x - int(rng.choice(dists)))
            t.height_field_raw[0:stop_x, start_y:stop_y] = int(rng.choice(heights))
            while start_x < t.width:
                stop_x = min(t.width, start_x + int(rng.choice(sizes)))
                t.height_field_raw[start_x:stop_x, start_y:stop_y] = int(rng.choice(heights))
                start_x += int(rng.choice(sizes)) + int(rng.choice(dists))
            start_y += int(rng.choice(sizes)) + int(rng.choice(dists))
    else:
        # column-major fill for wide tiles (terrain.py:224-238)
        start_x = 0
        while start_x < t.width:
            stop_x = min(t.width, start_x + int(rng.choice(sizes)))
            start_y = int(rng.integers(0, int(rng.choice(sizes))))
            stop_y = max(0, start_y - int(rng.choice(dists)))
            t.height_field_raw[start_x:stop_x, 0:stop_y] = int(rng.choice(heights))
            while start_y < t.length:
                stop_y = min(t.length, start_y + int(rng.choice(sizes)))
                t.height_field_raw[start_x:stop_x, start_y:stop_y] = int(rng.choice(heights))
                start_y += int(rng.choice(sizes)) + int(rng.choice(dists))
            start_x += int(rng.choice(sizes)) + int(rng.choice(dists))
    plat = int(platform_size / t.horizontal_scale)
    x1 = (t.width - plat) // 2
    x2 = (t.width + plat) // 2
    y1 = (t.length - plat) // 2
    y2 = (t.length + plat) // 2
    t.height_field_raw[x1:x2, y1:y2] = 0
    return t


# --- tile mixer / world assembly ------------------------------------------

def make_tile(cfg, rng, choice: float, difficulty: float) -> SubTerrain:
    """Pick + parameterize a generator (semantics of terrain.py:79-141).

    choice in [0,1) selects by cumulative terrain_proportions; difficulty in
    [0,1] scales hardness (Lite3 parameterization, terrain.py:95-113).
    """
    t = SubTerrain(width=int(cfg.terrain_length / cfg.horizontal_scale),
                   length=int(cfg.terrain_width / cfg.horizontal_scale),
                   vertical_scale=cfg.vertical_scale,
                   horizontal_scale=cfg.horizontal_scale)
    props = np.cumsum(np.asarray(cfg.terrain_proportions, dtype=np.float64))
    props = np.concatenate([props, np.full(8 - len(props), props[-1] if len(props) else 0)])

    slope = difficulty * 0.4
    stepping_stones_size = 1.0 * (1.05 - difficulty)
    step_height = 0.05 + 0.13 * difficulty
    discrete_obstacles_height = 0.05 + difficulty * 0.15
    stone_distance = 0.03 if difficulty == 0 else 0.06
    stones_max_height = 0.02 + 0.03 * difficulty
    stone_size = -0.1 * difficulty + 0.3
    gap_size = 0.8 * difficulty
    pit_depth = 0.8 * difficulty

    if choice < props[0]:
        if choice < props[0] / 2:
            slope *= -1
        pyramid_sloped_terrain(t, rng, slope=slope, platform_size=3.0)
    elif choice < props[1]:
        pyramid_sloped_terrain(t, rng, slope=slope, platform_size=3.0)
        random_uniform_terrain(t, rng, min_height=-0.05, max_height=0.05,
                               step=0.005, downsampled_scale=0.2)
    elif choice < props[3]:
        if choice < props[2]:
            step_height *= -1
        pyramid_stairs_terrain(t, rng, step_width=0.31, step_height=step_height,
                               platform_size=3.0)
    elif choice < props[4]:
        discrete_obstacles_terrain(t, rng, discrete_obstacles_height, 1.0, 2.0,
                                   20, platform_size=3.0)
    elif choice < props[5]:
        stepping_stones_terrain(t, rng, stone_size=stepping_stones_size,
                                stone_distance=stone_distance, max_height=0.0,
                                platform_size=1.0, depth=-2.0)
    elif choice < props[6]:
        gap_terrain(t, rng, gap_size=gap_size, platform_size=1.0)
    elif choice < props[7]:
        pit_terrain(t, rng, depth=pit_depth, platform_size=1.0)
    else:
        stones_everywhere_terrain(t, rng, stone_size=stone_size,
                                  stone_distance=stone_distance,
                                  max_height=stones_max_height,
                                  platform_size=1.3, depth=-2.0)
    return t


# family names in make_tile's cumulative-proportion order; the first four
# mirror the reference's terrain.py:95-113 choice ladder
FAMILIES = ["slope", "rough_slope", "stairs_up", "stairs_down",
            "discrete", "stepping_stones", "gap", "pit"]

# families where the robot's outward walk from the center platform is a
# DESCENT at positive difficulty: rough_slope is a raised pyramid (walking
# out = downhill on rough ground) and stairs_down flips step_height
# negative (make_tile above).  These are the two failure-frontier families
# in the X30 termination analysis (98-99% / 97% falls at high levels,
# docs/evidence/x30_terminations_r04.log).
DESCENT_FAMILIES = ("rough_slope", "stairs_down")


def column_families(cfg) -> list:
    """Family name per terrain column under the CURRICULUM layout
    (choice = j/num_cols + 0.001, the Terrain loop below / terrain.py:56).

    Shared by the descent-command clamp (env/legged_env.py) and
    scripts/analyze_terminations.py so the choice->family dispatch exists
    once."""
    props = np.cumsum(np.asarray(cfg.terrain_proportions, dtype=np.float64))
    props = np.concatenate(
        [props, np.full(8 - len(props), props[-1] if len(props) else 0)])
    out = []
    for j in range(cfg.num_cols):
        choice = j / cfg.num_cols + 0.001
        for i, p in enumerate(props):
            if choice < p:
                out.append(FAMILIES[i])
                break
        else:
            out.append(FAMILIES[-1])
    return out


_GENERATORS = {
    "pyramid_sloped_terrain": pyramid_sloped_terrain,
    "random_uniform_terrain": random_uniform_terrain,
    "pyramid_stairs_terrain": pyramid_stairs_terrain,
    "discrete_obstacles_terrain": discrete_obstacles_terrain,
    "stepping_stones_terrain": stepping_stones_terrain,
    "gap_terrain": gap_terrain,
    "pit_terrain": pit_terrain,
    "stones_everywhere_terrain": stones_everywhere_terrain,
}


class Terrain:
    """World heightfield: rows = difficulty levels, cols = terrain types.

    Mirrors legged_gym/utils/terrain.py:8-160 (curriculum / randomized /
    selected layouts, border, env origins at tile centers with the max
    height of the central 2x2 m patch).
    """

    def __init__(self, cfg, seed: int = 0, backend: str = "auto"):
        """backend: "python" | "native" | "auto" — "native" uses the C++
        generator (native/terrain_gen.cpp) via ctypes; "auto" prefers it
        when the shared library is available.  The two backends implement
        identical semantics but use independent RNG streams."""
        self.cfg = cfg
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        lpx = int(self.env_length / cfg.horizontal_scale)
        wpx = int(self.env_width / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_rows = cfg.num_rows * lpx + 2 * self.border
        self.tot_cols = cfg.num_cols * wpx + 2 * self.border

        # the native backend implements the curriculum/randomized layouts
        # only; selected mode (terrain.py:64-77) always uses the python
        # generators
        if backend in ("auto", "native") and not getattr(cfg, "selected",
                                                         False):
            from .. import native
            out = native.generate_terrain(cfg, seed) if native.available() \
                else None
            if out is not None:
                self.height_field_raw, self.env_origins = out
                self.backend = "native"
                return
            if backend == "native":
                raise RuntimeError("native terrain backend unavailable")
        elif backend == "native":
            raise RuntimeError(
                "native terrain backend does not implement selected mode")

        self.backend = "python"
        rng = np.random.default_rng(seed)
        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols),
                                         dtype=np.int16)
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

        selected_fn = None
        if getattr(cfg, "selected", False):
            selected_fn = _GENERATORS[cfg.selected_terrain_type]
            selected_kwargs = dict(cfg.selected_terrain_kwargs)
        for j in range(cfg.num_cols):
            for i in range(cfg.num_rows):
                if selected_fn is not None:       # selected mode (:64-77)
                    tile = SubTerrain(
                        width=lpx, length=wpx,
                        vertical_scale=cfg.vertical_scale,
                        horizontal_scale=cfg.horizontal_scale)
                    selected_fn(tile, rng, **selected_kwargs)
                elif cfg.curriculum:
                    difficulty = i / cfg.num_rows
                    choice = j / cfg.num_cols + 0.001
                    tile = make_tile(cfg, rng, choice, difficulty)
                else:
                    choice = rng.uniform(0, 1)
                    difficulty = rng.choice([0.25, 0.5, 0.75, 0.9])
                    tile = make_tile(cfg, rng, choice, difficulty)
                self._add_tile(tile, i, j, lpx, wpx)

    def _add_tile(self, tile: SubTerrain, i, j, lpx, wpx):
        sx = self.border + i * lpx
        sy = self.border + j * wpx
        self.height_field_raw[sx:sx + lpx, sy:sy + wpx] = tile.height_field_raw
        env_origin_x = (i + 0.5) * self.env_length
        env_origin_y = (j + 0.5) * self.env_width
        hs = tile.horizontal_scale
        x1 = int((self.env_length / 2.0 - 1) / hs)
        x2 = int((self.env_length / 2.0 + 1) / hs)
        y1 = int((self.env_width / 2.0 - 1) / hs)
        y2 = int((self.env_width / 2.0 + 1) / hs)
        env_origin_z = np.max(tile.height_field_raw[x1:x2, y1:y2]) * tile.vertical_scale
        self.env_origins[i, j] = [env_origin_x, env_origin_y, env_origin_z]

    def heights_meters(self) -> np.ndarray:
        return self.height_field_raw.astype(np.float32) * self.cfg.vertical_scale
