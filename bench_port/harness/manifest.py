"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by the name the manifest gives it:
  configs/<config>.json   the configuration as it is run (the entry's
                          "file"; task and train fields in full)
  mixes/<traffic>.json    the traffic mix: phase ("train": learn
                          iterations; "rollout": collects alone) and
                          num_envs
  metrics/<metric>.py     the metric's reader: read(run) -> value or None
  limits/<cell>.json      the limit of each number that decides `correct`
So a cell, a configuration, a mix or a metric is added with new files and
new entries, and no file changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def cell(manifest: dict, workload: str) -> dict:
    """The cell's workload entry, configuration entry and file, mix,
    end-to-end and per-layer metric entries, and limits."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise KeyError(f"workload {workload!r}: one of {sorted(by_name)}")
    w = by_name[workload]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]
    return dict(
        workload=w, config=cfg,
        config_file=json.loads((ROOT / cfg["file"]).read_text()),
        mix=json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m)],
        per_layer=[m for m in manifest["per_layer"] if reports(m)],
        limits=json.loads((BENCH / "limits" / f"{workload}.json")
                          .read_text())["limits"])


def reader(name: str):
    """The `read` function of bench_port/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
