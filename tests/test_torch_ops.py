"""ops/quat.py and ops/spatial.py of the torch port against the JAX package.

The same float32 inputs, made with numpy from a seed, go through both;
results agree to 1e-6 (the same operations in the same order, so only
libm differences in sin/cos/atan remain).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.ops import quat as jq
from deep_tracking_control_tpu.ops import spatial as js
from deep_tracking_control_tpu_torch.ops import quat as tq
from deep_tracking_control_tpu_torch.ops import spatial as ts

TOL = dict(rtol=1e-6, atol=1e-6)
N = 16


def _rng():
    return np.random.default_rng(1234)


def _unit_quats(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _quat_cases():
    rng = _rng()
    q = _unit_quats(rng)
    q2 = _unit_quats(rng)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    ang = rng.uniform(-7, 7, size=(N,)).astype(np.float32)
    ax = v / np.linalg.norm(v, axis=1, keepdims=True)
    w = rng.normal(size=(N, 3)).astype(np.float32)
    R = np.asarray(jq.quat_to_rotmat(jnp.asarray(q)))
    return {
        "normalize": ("normalize", (v,)),
        "quat_mul": ("quat_mul", (q, q2)),
        "quat_conjugate": ("quat_conjugate", (q,)),
        "quat_rotate": ("quat_rotate", (q, v)),
        "quat_rotate_inverse": ("quat_rotate_inverse", (q, v)),
        "quat_apply_yaw": ("quat_apply_yaw", (q, v)),
        "yaw_rot2d": ("yaw_rot2d", (q,)),
        "quat_to_rotmat": ("quat_to_rotmat", (q,)),
        "rotmat_to_quat": ("rotmat_to_quat", (R,)),
        "axis_angle_to_quat": ("axis_angle_to_quat", (ax, ang)),
        "quat_from_euler_xyz": ("quat_from_euler_xyz", (v[:, 0], v[:, 1], v[:, 2])),
        "get_euler_xyz": ("get_euler_xyz", (q,)),
        "yaw_quat": ("yaw_quat", (q,)),
        "wrap_to_pi": ("wrap_to_pi", (ang,)),
        "quat_integrate": ("quat_integrate", (q, w, 0.005)),
        "skew": ("skew", (v,)),
    }


def _spatial_cases():
    rng = _rng()

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    q = _unit_quats(rng)
    E = np.moveaxis(np.asarray(jq.quat_to_rotmat(jnp.asarray(q))), 0, -1)
    M = a(6, 6, N)
    spd = np.einsum("ikn,jkn->ijn", M, M) + 6.0 * np.eye(6, dtype=np.float32)[..., None]
    return {
        "cross3": ("cross3", (a(3, N), a(3, N))),
        "rmul": ("rmul", (a(3, 3, N), a(3, N))),
        "rtmul": ("rtmul", (a(3, 3, N), a(3, N))),
        "mmul": ("mmul", (a(3, 4, N), a(4, 2, N))),
        "dot_leading": ("dot_leading", (a(6, N), a(6, N))),
        "outer_leading": ("outer_leading", (a(6, N), a(6, N))),
        "xm_apply": ("xm_apply", (E, a(3, N), a(6, N))),
        "xm_inv_apply": ("xm_inv_apply", (E, a(3, N), a(6, N))),
        "xf_apply": ("xf_apply", (E, a(3, N), a(6, N))),
        "xf_inv_apply": ("xf_inv_apply", (E, a(3, N), a(6, N))),
        "crm": ("crm", (a(6, N), a(6, N))),
        "crf": ("crf", (a(6, N), a(6, N))),
        "motion_xform_matrix": ("motion_xform_matrix", (E, a(3, N))),
        "inertia_transform_to_parent": ("inertia_transform_to_parent",
                                        (E, a(3, N), a(6, 6, N))),
        "spatial_inertia": ("spatial_inertia",
                            (np.abs(a(N)) + 0.5, a(3, N), a(3, 3, N))),
        "imul": ("imul", (a(6, 6, N), a(6, N))),
        "solve_spd6": ("solve_spd6", (spd, a(6, N))),
        "axis_rotation": ("axis_rotation", ((0.0, -1.0, 0.0), a(4, N))),
    }


def _compare(jmod, tmod, name, args):
    jargs = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    targs = [torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
             for x in args]
    want = getattr(jmod, name)(*jargs)
    got = getattr(tmod, name)(*targs)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(_quat_cases()))
def test_quat_matches_jax(case):
    name, args = _quat_cases()[case]
    _compare(jq, tq, name, args)


@pytest.mark.parametrize("case", sorted(_spatial_cases()))
def test_spatial_matches_jax(case):
    name, args = _spatial_cases()[case]
    _compare(js, ts, name, args)
