"""Checkpoints as torch.save files, model_{it}.pt.

Counterpart of the JAX package's runner/checkpoint.py (orbax there; the
reference's torch.save/load of model + optimizer + iteration,
on_policy_runner.py:249-264).  A checkpoint is a dict of tensors, ints and
nested dicts only, so it loads with weights_only=True.
"""
from __future__ import annotations

import os
import re

import torch

_MODEL = re.compile(r"model_(\d+)\.pt$")


def save(path: str, tree: dict):
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)         # a reader never sees a partial file


def load(path: str, device) -> dict:
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def get_load_path(root: str, load_run: str = "-1", checkpoint: int = -1):
    """Checkpoint discovery (helpers.py:73-95): latest run dir / model_*.pt
    by number unless explicitly given."""
    def has_ckpt(d):
        p = os.path.join(root, d)
        return any(_MODEL.match(f) for f in os.listdir(p))

    runs = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))
    if load_run in ("-1", -1):
        # latest run that actually contains checkpoints (a resume launch
        # creates its own empty run dir before loading — skip it)
        runs = [d for d in runs if has_ckpt(d)]
    if not runs:
        raise FileNotFoundError(f"no runs with checkpoints in {root}")
    run = runs[-1] if load_run in ("-1", -1) else load_run
    run_dir = os.path.join(root, run)
    models = [(int(m.group(1)), d) for d in os.listdir(run_dir)
              if (m := _MODEL.match(d))]
    if not models:
        raise FileNotFoundError(f"no model_*.pt checkpoints in {run_dir}")
    if checkpoint in (-1, "-1"):
        step, name = max(models)
    else:
        name = f"model_{checkpoint}.pt"
    return os.path.join(run_dir, name)
