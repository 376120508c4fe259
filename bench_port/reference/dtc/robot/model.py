"""URDF parsing -> static kinematic-tree robot model.

Replaces the reference's `gym.load_asset` + asset-property call surface
(legged_robot.py:1089-1104: load_asset, get_asset_dof_count,
get_asset_rigid_body_names, get_asset_dof_names, dof props).  The model is
plain numpy, baked into the compiled XLA program as constants.

Semantics matched to Isaac Gym's asset import as the reference configures it:
  - collapse_fixed_joints=True with `dont_collapse="true"` on the ankle joints
    (legged_robot_config.py:104, Lite3.urdf:148) => FOOT links remain separate
    *reporting* bodies, but are welded to their parent for dynamics.  We merge
    their mass into the parent's spatial inertia (exactly equivalent for a
    weld) and keep them as contact/reporting sites.
  - DOF (joint) order and rigid-body order follow URDF document order, which
    matches Isaac's traversal for these assets.
  - torque limit = 0.8 * URDF effort (applied later by the actuator;
    legged_robot.py:503).
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np


def _vec(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.array(default, dtype=np.float64)
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static articulated-body description (all numpy; hashable by identity)."""

    name: str
    # dynamic tree (moving bodies only; 0 is the floating base)
    nb: int
    parent: np.ndarray        # (nb,) parent dynamic-body index; -1 for base
    joint_axis: np.ndarray    # (nb-1, 3) revolute axis in child frame
    joint_t: np.ndarray       # (nb-1, 3) child origin in parent coords
    joint_R: np.ndarray       # (nb-1, 3, 3) fixed child-axes-in-parent rotation
    mass: np.ndarray          # (nb,) incl. welded children
    com: np.ndarray           # (nb, 3) in body frame, incl. welded children
    inertia: np.ndarray       # (nb, 3, 3) about COM, incl. welded children
    dynamic_body_names: tuple
    joint_names: tuple
    # joint limits (URDF)
    pos_limit: np.ndarray     # (nb-1, 2)
    vel_limit: np.ndarray     # (nb-1,)
    effort_limit: np.ndarray  # (nb-1,)
    # reporting bodies: every URDF link in document order (incl. welded feet)
    body_names: tuple
    body_dyn_index: np.ndarray   # (num_bodies,) owning dynamic body
    body_offset: np.ndarray      # (num_bodies, 3) offset in dynamic-body frame
    # contact sites (foot spheres from URDF; other bodies get sampled points)
    foot_body_index: np.ndarray  # indices into body_names for *_FOOT links
    foot_dyn_index: np.ndarray   # dynamic body each foot welds to
    foot_offset: np.ndarray      # (nf, 3)
    foot_radius: np.ndarray      # (nf,)

    @property
    def nq(self) -> int:
        return self.nb - 1

    @property
    def num_bodies(self) -> int:
        return len(self.body_names)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def match_bodies(self, keyword: str) -> list:
        """All reporting-body indices whose name contains keyword
        (mirrors the substring matching at legged_robot.py:1105-1129)."""
        return [i for i, n in enumerate(self.body_names) if keyword in n]


def _parse_inertial(link) -> tuple:
    inertial = link.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    origin = inertial.find("origin")
    com = _vec(origin.get("xyz") if origin is not None else None)
    mass = float(inertial.find("mass").get("value"))
    ine = inertial.find("inertia")
    ixx = float(ine.get("ixx", 0)); iyy = float(ine.get("iyy", 0)); izz = float(ine.get("izz", 0))
    ixy = float(ine.get("ixy", 0)); ixz = float(ine.get("ixz", 0)); iyz = float(ine.get("iyz", 0))
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    if origin is not None and origin.get("rpy") is not None:
        R = _rpy_to_mat(_vec(origin.get("rpy")))
        I = R @ I @ R.T
    return mass, com, I


def _merge_weld(mass_a, com_a, I_a, mass_b, com_b, I_b):
    """Merge body b (at com_b, in a's frame) into body a."""
    m = mass_a + mass_b
    if m <= 0:
        return m, com_a, I_a
    com = (mass_a * com_a + mass_b * com_b) / m
    def shift(I, mm, c, new_c):
        d = c - new_c
        return I + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m, com, shift(I_a, mass_a, com_a, com) + shift(I_b, mass_b, com_b, com)


def load_urdf(path: str) -> RobotModel:
    """Parse a URDF into a RobotModel (Lite3/X30-style quadrupeds or any
    single-chain-per-branch revolute tree with optional welded leaf links)."""
    tree = ET.parse(path)
    root = tree.getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    link_order = [l.get("name") for l in root.findall("link")]
    joints = root.findall("joint")

    child_of = {}
    for j in joints:
        child_of[j.find("child").get("link")] = j
    root_links = [n for n in link_order if n not in child_of]
    assert len(root_links) == 1, f"expected one root link, got {root_links}"

    # dynamic bodies: root + children of revolute joints, URDF document order
    dyn_names = [root_links[0]]
    for n in link_order:
        j = child_of.get(n)
        if j is not None and j.get("type") in ("revolute", "continuous"):
            dyn_names.append(n)
    dyn_idx = {n: i for i, n in enumerate(dyn_names)}

    nb = len(dyn_names)
    parent = np.full(nb, -1, dtype=np.int32)
    joint_axis = np.zeros((nb - 1, 3))
    joint_t = np.zeros((nb - 1, 3))
    joint_R = np.tile(np.eye(3), (nb - 1, 1, 1))
    pos_limit = np.zeros((nb - 1, 2))
    vel_limit = np.zeros(nb - 1)
    effort_limit = np.zeros(nb - 1)
    joint_names = []

    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for n in dyn_names:
        i = dyn_idx[n]
        mass[i], com[i], inertia[i] = _parse_inertial(links[n])

    for n in dyn_names[1:]:
        j = child_of[n]
        i = dyn_idx[n]
        parent[i] = dyn_idx[j.find("parent").get("link")]
        origin = j.find("origin")
        joint_t[i - 1] = _vec(origin.get("xyz") if origin is not None else None)
        if origin is not None and origin.get("rpy") is not None:
            joint_R[i - 1] = _rpy_to_mat(_vec(origin.get("rpy")))
        joint_axis[i - 1] = _vec(j.find("axis").get("xyz"), (1.0, 0.0, 0.0))
        joint_axis[i - 1] /= np.linalg.norm(joint_axis[i - 1])
        lim = j.find("limit")
        pos_limit[i - 1] = [float(lim.get("lower", -1e9)), float(lim.get("upper", 1e9))]
        vel_limit[i - 1] = float(lim.get("velocity", 1e9))
        effort_limit[i - 1] = float(lim.get("effort", 1e9))
        joint_names.append(j.get("name"))

    # fixed-joint (welded) links: merge inertials into parent, keep as sites
    body_names = []
    body_dyn_index = []
    body_offset = []
    foot_body_index, foot_dyn_index, foot_offset, foot_radius = [], [], [], []
    for n in link_order:
        j = child_of.get(n)
        if n in dyn_idx:
            body_names.append(n)
            body_dyn_index.append(dyn_idx[n])
            body_offset.append(np.zeros(3))
        elif j is not None and j.get("type") == "fixed":
            pname = j.find("parent").get("link")
            assert pname in dyn_idx, "chained fixed joints not supported yet"
            pi = dyn_idx[pname]
            origin = j.find("origin")
            off = _vec(origin.get("xyz") if origin is not None else None)
            m_b, com_b, I_b = _parse_inertial(links[n])
            mass[pi], com[pi], inertia[pi] = _merge_weld(
                mass[pi], com[pi], inertia[pi], m_b, com_b + off, I_b)
            body_names.append(n)
            body_dyn_index.append(pi)
            body_offset.append(off)
            # sphere collision => foot site
            coll = links[n].find("collision")
            if coll is not None:
                sph = coll.find("geometry/sphere")
                if sph is not None:
                    foot_body_index.append(len(body_names) - 1)
                    foot_dyn_index.append(pi)
                    foot_offset.append(off)
                    foot_radius.append(float(sph.get("radius")))

    return RobotModel(
        name=root.get("name"),
        nb=nb,
        parent=parent,
        joint_axis=joint_axis,
        joint_t=joint_t,
        joint_R=joint_R,
        mass=mass,
        com=com,
        inertia=inertia,
        dynamic_body_names=tuple(dyn_names),
        joint_names=tuple(joint_names),
        pos_limit=pos_limit,
        vel_limit=vel_limit,
        effort_limit=effort_limit,
        body_names=tuple(body_names),
        body_dyn_index=np.array(body_dyn_index, dtype=np.int32),
        body_offset=np.array(body_offset),
        foot_body_index=np.array(foot_body_index, dtype=np.int32),
        foot_dyn_index=np.array(foot_dyn_index, dtype=np.int32),
        foot_offset=np.array(foot_offset),
        foot_radius=np.array(foot_radius),
    )


_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "resources")


def resource_path(rel: str) -> str:
    return os.path.join(_RESOURCE_DIR, rel)
