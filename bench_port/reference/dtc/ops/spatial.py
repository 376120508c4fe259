"""Spatial (6D) rigid-body algebra on torch tensors.

Counterpart of the JAX package's ops/spatial.py, with the same conventions
(Featherstone, "Rigid Body Dynamics Algorithms"):
  - motion vector  m = [omega(3); v(3)]
  - force  vector  f = [n(3); f(3)]          (torque about frame origin first)
  - spatial inertia I is 6x6 about the body-frame origin.

Layout: component axes FIRST, environment batch axis LAST — motion (6, N),
rotation (3, 3, N), inertia (6, 6, N) — as in the JAX package, so both
compare element for element.  The small products are unrolled
multiply-adds over the leading axes, which keeps the order of the float
operations the JAX package uses; each term is taken for every output
element at once (a broadcast product), so a product costs a few tensor
ops, not one per element.
"""
from __future__ import annotations

import torch


def _batch(x, lead, nb):
    """x with `lead` component axes and its batch axes widened to nb by
    singleton axes after the components: batches broadcast from the
    right, as in the element-wise forms of these products."""
    extra = nb - (x.dim() - lead)
    if extra <= 0:
        return x
    return x.reshape(x.shape[:lead] + (1,) * extra + x.shape[lead:])


def _sum_in_order(terms):
    """terms[0] + terms[1] + ... in that order."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def cross3(a, b):
    """Cross product over leading component axis: (3, ...) x (3, ...);
    component i is a[i+1] b[i+2] - a[i+2] b[i+1], indices mod 3."""
    nb = max(a.dim(), b.dim()) - 1
    a, b = _batch(a, 1, nb), _batch(b, 1, nb)
    return a.roll(-1, 0) * b.roll(-2, 0) - a.roll(-2, 0) * b.roll(-1, 0)


def rmul(R, v):
    """(n,n,...) @ (n,...) -> (n,...). R maps coords; batch trails."""
    nb = max(R.dim() - 2, v.dim() - 1)
    R, v = _batch(R, 2, nb), _batch(v, 1, nb)
    return _sum_in_order((R * v.unsqueeze(0)).unbind(1))


def rtmul(R, v):
    """R^T @ v with trailing batch."""
    nb = max(R.dim() - 2, v.dim() - 1)
    R, v = _batch(R, 2, nb), _batch(v, 1, nb)
    return _sum_in_order((R * v.unsqueeze(1)).unbind(0))


def mmul(A, B):
    """(r,k,...) @ (k,c,...) -> (r,c,...) as unrolled multiply-adds: every
    output element is A[i,0]B[0,j] + A[i,1]B[1,j] + ... in that order,
    each term taken for all (i, j) at once."""
    nb = max(A.dim(), B.dim()) - 2
    A, B = _batch(A, 2, nb), _batch(B, 2, nb)
    return _sum_in_order((A.unsqueeze(2) * B.unsqueeze(0)).unbind(1))


def dot_leading(a, b):
    """Sum_i a[i]*b[i] over the leading axis (unrolled)."""
    nb = max(a.dim(), b.dim()) - 1
    return _sum_in_order((_batch(a, 1, nb) * _batch(b, 1, nb)).unbind(0))


def outer_leading(a, b):
    """(n,...),(m,...) -> (n,m,...) outer product on leading axes."""
    nb = max(a.dim(), b.dim()) - 1
    return _batch(a, 1, nb).unsqueeze(1) * _batch(b, 1, nb).unsqueeze(0)


# A child frame c has origin r (in parent coords) and rotation E = c_R_p
# (parent coords -> child coords).  cXp = [[E, 0], [-E r^, E]] maps motion
# vectors from parent to child coords; the force transform is its
# inverse-transpose.

def xm_apply(E, r, m):
    """Motion vector: parent coords -> child coords. m: (6, ...)."""
    w, v = m[:3], m[3:]
    return torch.cat([rmul(E, w), rmul(E, v - cross3(r, w))])


def xm_inv_apply(E, r, m):
    """Motion vector: child coords -> parent coords."""
    w, v = m[:3], m[3:]
    wp = rtmul(E, w)
    return torch.cat([wp, rtmul(E, v) + cross3(r, wp)])


def xf_apply(E, r, f):
    """Force vector: parent coords -> child coords."""
    n, ff = f[:3], f[3:]
    return torch.cat([rmul(E, n - cross3(r, ff)), rmul(E, ff)])


def xf_inv_apply(E, r, f):
    """Force vector: child coords -> parent coords."""
    n, ff = f[:3], f[3:]
    fp = rtmul(E, ff)
    return torch.cat([rtmul(E, n) + cross3(r, fp), fp])


def crm(v, m):
    """Motion cross product  v x m  (both (6, ...))."""
    w, vl = v[:3], v[3:]
    mw, mv = m[:3], m[3:]
    return torch.cat([cross3(w, mw), cross3(vl, mw) + cross3(w, mv)])


def crf(v, f):
    """Force cross product  v x* f."""
    w, vl = v[:3], v[3:]
    n, ff = f[:3], f[3:]
    return torch.cat([cross3(w, n) + cross3(vl, ff), cross3(w, ff)])


def _hat(rb, z):
    rx, ry, rz = rb[0], rb[1], rb[2]
    return torch.stack([
        torch.stack([z, -rz, ry]),
        torch.stack([rz, z, -rx]),
        torch.stack([-ry, rx, z]),
    ])


def motion_xform_matrix(E, r):
    """The 6x6 motion transform cXp = [[E,0],[-E r^, E]], trailing batch.

    E: (3,3,...), r: (3,...) -> (6,6,...)."""
    batch = torch.broadcast_shapes(E.shape[2:], r.shape[1:])
    Eb = E.expand((3, 3) + batch)
    rb = r.expand((3,) + batch)
    z = torch.zeros(batch, dtype=Eb.dtype, device=Eb.device)
    nErh = -mmul(Eb, _hat(rb, z))
    top = torch.cat([Eb, torch.zeros_like(Eb)], dim=1)
    bot = torch.cat([nErh, Eb], dim=1)
    return torch.cat([top, bot], dim=0)


def inertia_transform_to_parent(E, r, I_c):
    """Articulated inertia: child coords -> parent coords.

    I^p = X^T I^c X with X = cXp = [[E,0],[F,E]], F = -E r^ (Featherstone
    2.66), block-wise on 3x3 blocks:
      I^p = [[E^T(AE+BF) + F^T(CE+DF),  E^T B E + F^T D E],
             [E^T(CE+DF),               E^T D E]].
    I_c: (6,6,...) -> (6,6,...)."""
    A, B = I_c[:3, :3], I_c[:3, 3:]
    C, D = I_c[3:, :3], I_c[3:, 3:]
    batch = torch.broadcast_shapes(E.shape[2:], r.shape[1:])
    rb = r.expand((3,) + batch)
    z = torch.zeros(batch, dtype=E.dtype, device=E.device)
    Eb = E.expand((3, 3) + batch)
    F = -mmul(Eb, _hat(rb, z))
    Et = Eb.transpose(0, 1)
    Ft = F.transpose(0, 1)
    AE_BF = mmul(A, Eb) + mmul(B, F)
    CE_DF = mmul(C, Eb) + mmul(D, F)
    DE = mmul(D, Eb)
    bl = mmul(Et, CE_DF)                      # bottom-left = top-right^T
    top = torch.cat([mmul(Et, AE_BF) + mmul(Ft, CE_DF), bl.transpose(0, 1)],
                    dim=1)
    bot = torch.cat([bl, mmul(Et, DE)], dim=1)
    return torch.cat([top, bot], dim=0)


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia (6,6,...) about the body origin from mass/COM/I_com.

    mass: (...), com: (3, ...), inertia_com: (3,3,...).
    I = [[I_com + m c^ c^T, m c^], [m c^T, m 1]]."""
    chat = _hat(com, torch.zeros_like(com[0]))
    m_chat = mass * chat
    top_left = inertia_com + mmul(m_chat, chat.transpose(0, 1))
    top = torch.cat([top_left, m_chat], dim=1)
    eye = torch.zeros_like(chat)
    for i in range(3):
        eye[i, i] = 1.0
    bot = torch.cat([m_chat.transpose(0, 1), mass * eye], dim=1)
    return torch.cat([top, bot], dim=0)


def imul(I, m):
    """(6,6,...) @ (6,...) -> (6,...) as unrolled multiply-adds (in the
    order j = 0..5, each term for all six rows at once)."""
    return rmul(I, m)


def solve_spd6(A, b, reg: float = 1e-8):
    """Solve A x = b for symmetric positive-definite 6x6 A, batched on the
    trailing axis, via an unrolled LDL^T factorization.

    A: (6,6,...), b: (6,...) -> x: (6,...)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    for j in range(n):
        d = A[j, j] + reg
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        D[j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i] / D[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return torch.stack(x)


def axis_rotation(axis, q):
    """Rodrigues rotation about a fixed unit axis by batched angle q.

    axis: (3,) static floats; q: (...) -> R (3,3,...)."""
    x, y, z = (float(a) for a in axis)
    c, s = torch.cos(q), torch.sin(q)
    C = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s]),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s]),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C]),
    ])
