"""Deployment export of trained policies with `torch.export`.

Counterpart of the JAX package's runner/export.py, which writes the
deterministic teacher policy (act_teacher) as a StableHLO artifact; the
reference stack wrote TorchScript (helpers.py:150-189
export_policy_as_jit).  Here `torch.export` traces act_teacher at a fixed
deployment batch into an ExportedProgram saved as `<path>/policy.pt2`,
which `torch.export.load` (or `load_policy`) runs without this package's
model classes.

The program keeps the device of the net it was exported from: its weights
and every tensor its graph makes live there, so a program exported on the
card runs on the card and one exported on the CPU runs on the CPU.  To
run on another device, export from a copy of the net moved there
(`copy.deepcopy(net).to(device)`).
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn

FILE = "policy.pt2"


class _Teacher(nn.Module):
    """act_teacher(obs, obs_history, privileged_obs) -> actions as a
    module's forward, the form `torch.export` traces."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, obs, obs_history, privileged_obs):
        return self.net.act_teacher(obs, obs_history, privileged_obs)


def export_policy(net, num_obs: int, num_obs_history: int,
                  num_privileged_obs: int, path: str,
                  batch_size: int = 1) -> str:
    """Write act_teacher(obs, obs_history, privileged_obs) -> actions at a
    fixed deployment batch (default 1 robot), float32 inputs on the net's
    device.  Returns the written file (<path>/policy.pt2).  Only the
    ActorCriticDecoder has act_teacher, as in the JAX package: another net
    raises ValueError."""
    if not hasattr(net, "act_teacher"):
        raise ValueError(f"export_policy exports act_teacher, which "
                         f"{type(net).__name__} does not have")
    os.makedirs(path, exist_ok=True)
    dev = next(net.parameters()).device
    args = tuple(torch.zeros((batch_size, d), device=dev)
                 for d in (num_obs, num_obs_history, num_privileged_obs))
    with torch.no_grad():
        program = torch.export.export(_Teacher(net).eval(), args)
    out = os.path.join(path, FILE)
    torch.export.save(program, out)
    return out


def load_policy(path: str):
    """Load an exported policy; returns fn(obs, hist, priv) -> actions on
    the device it was exported on."""
    module = torch.export.load(os.path.join(path, FILE)).module()

    @torch.no_grad()
    def policy(obs, obs_history, privileged_obs):
        return module(obs, obs_history, privileged_obs)

    return policy
