"""Built-in quadruped robot descriptions (Lite3, X30) as data tables.

The reference ships these as URDF assets (resources/robots/Lite3/urdf/
Lite3.urdf, resources/robots/X30/urdf/X30.urdf) consumed by Isaac's
load_asset.  Here the same physical parameters are encoded directly as
Python data (each number cited below), assembled into a RobotModel by
`_build_quadruped`.  `to_urdf()` can emit an equivalent URDF for
round-tripping through `model.load_urdf` (used by tests) or for users who
want the file form.

Body order matches Isaac's URDF document order:
  TORSO, then per leg (FL, FR, HL, HR): HIP, THIGH, SHANK, FOOT.
Feet are welded (fixed ankle joints with dont_collapse, Lite3.urdf:148) —
separate reporting bodies, dynamics merged into the shank.
"""
from __future__ import annotations

import io

import numpy as np

from .model import RobotModel, _merge_weld

LEGS = ("FL", "FR", "HL", "HR")


def _build_quadruped(name, torso, hips, thighs, shanks, foot,
                     hip_origin, thigh_origin, knee_origin, ankle_origin,
                     hip_limits, thigh_limit, knee_limit) -> RobotModel:
    """Assemble a 13-dynamic-body quadruped RobotModel.

    Args per-link dicts: {mass, com, inertia(6: ixx iyy izz ixy ixz iyz) or
    full 3x3, rpy optional}; origins are functions leg->xyz.
    """
    def inert(d):
        i = d["inertia"]
        if len(i) == 6:
            ixx, iyy, izz, ixy, ixz, iyz = i
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        else:
            I = np.asarray(i, dtype=np.float64).reshape(3, 3)
        if "rpy" in d and any(abs(v) > 0 for v in d["rpy"]):
            from .model import _rpy_to_mat
            R = _rpy_to_mat(np.asarray(d["rpy"], dtype=np.float64))
            I = R @ I @ R.T
        return I

    dyn_names = [torso["name"]]
    mass = [torso["mass"]]
    com = [np.asarray(torso["com"], dtype=np.float64)]
    inertia = [inert(torso)]
    parent = [-1]
    joint_axis, joint_t, pos_limit, vel_limit, effort_limit = [], [], [], [], []
    joint_names = []
    body_names = [torso["name"]]
    body_dyn_index = [0]
    body_offset = [np.zeros(3)]
    foot_body_index, foot_dyn_index, foot_offset, foot_radius = [], [], [], []

    axes = {"HipX": (-1.0, 0.0, 0.0), "HipY": (0.0, -1.0, 0.0), "Knee": (0.0, -1.0, 0.0)}
    for li, leg in enumerate(LEGS):
        chain = [
            (f"{leg}_HIP", hips[leg], "HipX", hip_origin(leg), hip_limits(leg)),
            (f"{leg}_THIGH", thighs[leg], "HipY", thigh_origin(leg), thigh_limit),
            (f"{leg}_SHANK", shanks[leg], "Knee", knee_origin, knee_limit),
        ]
        for lname, d, jkind, origin, lim in chain:
            pidx = 0 if jkind == "HipX" else len(dyn_names) - 1
            parent.append(pidx)
            dyn_names.append(lname)
            mass.append(d["mass"])
            com.append(np.asarray(d["com"], dtype=np.float64))
            inertia.append(inert(d))
            joint_axis.append(np.asarray(axes[jkind]))
            joint_t.append(np.asarray(origin, dtype=np.float64))
            pos_limit.append([lim[0], lim[1]])
            effort_limit.append(lim[2])
            vel_limit.append(lim[3])
            joint_names.append(f"{leg}_{jkind}_joint")
            body_names.append(lname)
            body_dyn_index.append(len(dyn_names) - 1)
            body_offset.append(np.zeros(3))
        # welded foot
        shank_idx = len(dyn_names) - 1
        off = np.asarray(ankle_origin, dtype=np.float64)
        mass[shank_idx], com[shank_idx], inertia[shank_idx] = _merge_weld(
            mass[shank_idx], com[shank_idx], inertia[shank_idx],
            foot["mass"], np.asarray(foot.get("com", (0, 0, 0))) + off,
            inert(foot))
        body_names.append(f"{leg}_FOOT")
        body_dyn_index.append(shank_idx)
        body_offset.append(off)
        foot_body_index.append(len(body_names) - 1)
        foot_dyn_index.append(shank_idx)
        foot_offset.append(off)
        foot_radius.append(foot["radius"])

    nb = len(dyn_names)
    return RobotModel(
        name=name,
        nb=nb,
        parent=np.array(parent, dtype=np.int32),
        joint_axis=np.array(joint_axis),
        joint_t=np.array(joint_t),
        joint_R=np.tile(np.eye(3), (nb - 1, 1, 1)),
        mass=np.array(mass),
        com=np.array(com),
        inertia=np.array(inertia),
        dynamic_body_names=tuple(dyn_names),
        joint_names=tuple(joint_names),
        pos_limit=np.array(pos_limit),
        vel_limit=np.array(vel_limit),
        effort_limit=np.array(effort_limit),
        body_names=tuple(body_names),
        body_dyn_index=np.array(body_dyn_index, dtype=np.int32),
        body_offset=np.array(body_offset),
        foot_body_index=np.array(foot_body_index, dtype=np.int32),
        foot_dyn_index=np.array(foot_dyn_index, dtype=np.int32),
        foot_offset=np.array(foot_offset),
        foot_radius=np.array(foot_radius),
    )


def lite3() -> RobotModel:
    """DeepRobotics Lite3 (parameters from resources/robots/Lite3/urdf/Lite3.urdf).

    Torso: Lite3.urdf:6-11; hips :31-59,156-185,283-311,408-436;
    thighs :60-88,186-215,312-340,437-465; shanks :89-117,216-244,341-369,
    466-494; feet (0.022 m spheres, welded at z=-0.21012) :119-153 etc.
    """
    hip_coms = {
        "FL": (-0.00601, -0.0066532, 0.00034295),
        "FR": (-0.010579, 0.011358, 0.00048546),
        "HL": (0.010905, -0.012636, 0.001051),
        "HR": (0.010354, 0.011423, 0.00049498),
    }
    hip_inertias = {
        "FL": (0.0003949, 0.0004028, 0.0004472, 0, 0, 0),
        "FR": (0.0004472, 0.0004028, 0.0003949, 0, 0, 0),
        "HL": (0.0003949, 0.0004028, 0.0004472, 0, 0, 0),
        "HR": (0.0003949, 0.0004028, 0.0004472, 0, 0, 0),
    }
    thigh_coms = {
        "FL": (-0.0052817, -0.014632, -0.042672),
        "FR": (-0.0039245, 0.025256, -0.025146),
        "HL": (-0.0057137, -0.014631, -0.042453),
        "HR": (-0.0031903, 0.02526, -0.025617),
    }
    hips = {leg: dict(mass=0.550, com=hip_coms[leg], inertia=hip_inertias[leg])
            for leg in LEGS}
    thighs = {leg: dict(mass=0.86, com=thigh_coms[leg],
                        inertia=(0.005736, 0.004960, 0.001436, 0, 0, 0))
              for leg in LEGS}
    shanks = {leg: dict(mass=0.153, com=(0.0064794, 0.0, -0.12157),
                        inertia=(0.00089039, 0.00090672, 3.1266e-05, 0, 0, 0))
              for leg in LEGS}
    sign = lambda leg: (1.0 if leg[0] == "F" else -1.0, 1.0 if leg[1] == "L" else -1.0)
    return _build_quadruped(
        name="Lite3",
        torso=dict(mass=5.6056, com=(0, 0, 0),
                   inertia=(0.02456, 0.05518, 0.07016, 0, 0, 0), name="TORSO"),
        hips=hips, thighs=thighs, shanks=shanks,
        foot=dict(mass=0.02, inertia=(0, 0, 0, 0, 0, 0), radius=0.022),
        hip_origin=lambda leg: (0.1745 * sign(leg)[0], 0.062 * sign(leg)[1], 0.0),
        thigh_origin=lambda leg: (0.0, 0.09735 * sign(leg)[1], 0.0),
        knee_origin=(0.0, 0.0, -0.20),
        ankle_origin=(0.0, 0.0, -0.21012),
        hip_limits=lambda leg: (-0.523, 0.523, 30.0, 20.0),
        thigh_limit=(-2.67, 0.314, 30.0, 20.0),
        knee_limit=(0.524, 2.792, 30.0, 20.0),
    )


def x30() -> RobotModel:
    """DeepRobotics X30 (parameters from resources/robots/X30/urdf/X30.urdf).

    Torso :11-15; hips :38-58 (+mirrors, incl. inertial rpy flips :151,263,
    374); thighs :61-87; shanks :90-128; feet 0.03 m spheres at z=-0.31
    :131-146.  HipX limits are asymmetric and mirrored L/R (:58 vs :169).
    """
    hips = {
        "FL": dict(mass=1.43, com=(-0.0018591, -0.011377, 0.00027039),
                   inertia=(0.0014068, 0.0026782, 0.0015918, -1.8545e-05, 2.7664e-06, 2.1221e-06)),
        "FR": dict(mass=1.43, com=(-0.0018591, 0.011377, -2.7675e-05),
                   inertia=(0.0014068, 0.0026782, 0.0015918, 1.8545e-05, -4.1487e-06, 7.0795e-06),
                   rpy=(3.14159, 0.0, 0.0)),
        "HL": dict(mass=1.43, com=(0.0018591, -0.011377, -2.7675e-05),
                   inertia=(0.0014068, 0.0026782, 0.0015918, 1.8545e-05, 4.1487e-06, -7.0795e-06),
                   rpy=(0.0, 3.14159, 0.0)),
        "HR": dict(mass=1.43, com=(0.0018591, 0.011377, 0.00027039),
                   inertia=(0.0014068, 0.0026782, 0.0015918, -1.8545e-05, -2.7664e-06, -2.1221e-06),
                   rpy=(3.14159, 3.14159, 0.0)),
    }
    thighs = {
        "FL": dict(mass=4.0809, com=(-0.0087581, -0.023554, -0.055162),
                   inertia=(0.012604, 0.0164, 0.0061084, 0.00020291, -0.00030875, 0.00036593)),
        "FR": dict(mass=4.0809, com=(-0.0087433, 0.023551, -0.055154),
                   inertia=(0.012604, 0.0164, 0.0061086, -0.00020374, -0.0003086, -0.00036585)),
        "HL": dict(mass=4.0809, com=(-0.0087581, -0.023554, -0.055162),
                   inertia=(0.012604, 0.0164, 0.0061084, 0.00020291, -0.00030875, 0.00036593)),
        "HR": dict(mass=4.0809, com=(-0.0087433, 0.023551, -0.055154),
                   inertia=(0.012604, 0.0164, 0.0061086, -0.00020374, -0.0003086, -0.00036585)),
    }
    shanks = {leg: dict(mass=0.71386, com=(0.014851, 2.0685e-05, -0.12283),
                        inertia=(0.0093039, 0.0096272, 0.00041542, 1.7693e-07, 0.00034843, -3.7717e-06))
              for leg in LEGS}
    sign = lambda leg: (1.0 if leg[0] == "F" else -1.0, 1.0 if leg[1] == "L" else -1.0)

    def hip_limits(leg):
        # left: [-0.323, 0.585]; right mirrored: [-0.585, 0.323] (X30.urdf:58,169)
        if leg[1] == "L":
            return (-0.323, 0.585, 84.0, 17.5)
        return (-0.585, 0.323, 84.0, 17.5)

    return _build_quadruped(
        name="X30",
        torso=dict(mass=30.7, com=(0, 0, 0),
                   inertia=(0.364306, 0.597627, 0.757267, 0.00018421, 0.00027469, 0.00026784),
                   name="TORSO"),
        hips=hips, thighs=thighs, shanks=shanks,
        foot=dict(mass=0.06, inertia=(1e-12, 1e-12, 1e-12, 0, 0, 0), radius=0.03),
        hip_origin=lambda leg: (0.291 * sign(leg)[0], 0.08 * sign(leg)[1], 0.0),
        thigh_origin=lambda leg: (0.0, 0.11675 * sign(leg)[1], 0.0),
        knee_origin=(0.0, 0.0, -0.30),
        ankle_origin=(0.0, 0.0, -0.31),
        hip_limits=hip_limits,
        thigh_limit=(-2.967, 0.262, 84.0, 17.5),
        knee_limit=(0.349, 2.531, 180.0, 16.1),
    )


def to_urdf(m: RobotModel) -> str:
    """Emit an URDF equivalent of a RobotModel (round-trip/testing/export).

    Links are emitted in reporting-body (document) order so a parse of the
    output reproduces the same body ordering."""
    out = io.StringIO()
    out.write(f'<?xml version="1.0"?>\n<robot name="{m.name}">\n')
    dyn_names = m.dynamic_body_names
    dyn_pos = {n: i for i, n in enumerate(dyn_names)}
    foot_of = {int(m.foot_body_index[k]): k for k in range(len(m.foot_body_index))}
    for b, name in enumerate(m.body_names):
        if name in dyn_pos:
            i = dyn_pos[name]
            I = m.inertia[i]
            out.write(f'  <link name="{name}">\n    <inertial>\n')
            out.write(f'      <origin xyz="{m.com[i,0]} {m.com[i,1]} {m.com[i,2]}"/>\n')
            out.write(f'      <mass value="{m.mass[i]}"/>\n')
            out.write(f'      <inertia ixx="{I[0,0]}" ixy="{I[0,1]}" ixz="{I[0,2]}" '
                      f'iyy="{I[1,1]}" iyz="{I[1,2]}" izz="{I[2,2]}"/>\n')
            out.write('    </inertial>\n  </link>\n')
            if i > 0:
                j = i - 1
                a, t = m.joint_axis[j], m.joint_t[j]
                lo, hi = m.pos_limit[j]
                out.write(f'  <joint name="{m.joint_names[j]}" type="revolute">\n')
                out.write(f'    <origin xyz="{t[0]} {t[1]} {t[2]}"/>\n')
                out.write(f'    <parent link="{dyn_names[m.parent[i]]}"/>\n')
                out.write(f'    <child link="{name}"/>\n')
                out.write(f'    <axis xyz="{a[0]} {a[1]} {a[2]}"/>\n')
                out.write(f'    <limit lower="{lo}" upper="{hi}" '
                          f'effort="{m.effort_limit[j]}" velocity="{m.vel_limit[j]}"/>\n')
                out.write('  </joint>\n')
        elif b in foot_of:
            k = foot_of[b]
            off = m.foot_offset[k]
            out.write(f'  <link name="{name}">\n')
            out.write('    <inertial><mass value="0.0"/>'
                      '<inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/></inertial>\n')
            out.write(f'    <collision><geometry><sphere radius="{m.foot_radius[k]}"/>'
                      '</geometry></collision>\n  </link>\n')
            out.write(f'  <joint name="{name}_Ankle" type="fixed" dont_collapse="true">\n')
            out.write(f'    <origin xyz="{off[0]} {off[1]} {off[2]}"/>\n')
            out.write(f'    <parent link="{dyn_names[m.foot_dyn_index[k]]}"/>\n')
            out.write(f'    <child link="{name}"/>\n  </joint>\n')
    out.write('</robot>\n')
    return out.getvalue()


_REGISTRY = {"lite3": lite3, "x30": x30}


def get_robot(name: str) -> RobotModel:
    return _REGISTRY[name.lower()]()
