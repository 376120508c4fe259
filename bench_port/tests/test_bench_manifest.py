"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from harness import config as hc
from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = dict(
    top={"command", "paths", "run_seconds", "configs", "workloads",
         "end_to_end", "per_layer"},
    config={"name", "source", "file", "reduced", "why"},
    workload={"name", "config", "traffic", "chips", "why"},
    end_to_end={"name", "unit", "better", "bound", "source"},
    per_layer={"name", "unit", "better", "source", "layer", "moves"})


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape(m):
    assert set(m) == KEYS["top"]
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    assert m["command"][1].split("/")[0] in m["paths"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries(m):
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        key = "config" if kind == "configs" else kind.rstrip("s")
        for e in m[kind]:
            extra = set(e) - KEYS[key] - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            assert not extra and KEYS[key] <= set(e), (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in names
            names.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k]), (kind, e["name"], k)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in e2e


def test_cells(m):
    configs = {c["name"]: c for c in m["configs"]}
    used = set()
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
    pairs = set()
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"]) and line(w["why"])
        used.add(w["config"])
        cell = manifest.cell(m, w["name"])
        reported = {e["name"] for e in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for e in cell["per_layer"]:
            assert e["moves"] in reported
            assert (manifest.BENCH / "metrics" / f"{e['name']}.py").is_file()
        for e in cell["end_to_end"]:
            assert (manifest.BENCH / "metrics" / f"{e['name']}.py").is_file()
        assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
        assert cell["mix"]["phase"] in ("train", "rollout")
    assert used == set(configs)


@pytest.mark.parametrize("name", ["lite3_dtc", "x30_dtc"])
def test_config_file(m, name):
    """The file is under paths, states the task and train fields in full,
    builds into the port's and the reference's dataclasses alike, and
    changes nothing from the port's registry entry but what `reduced`
    names (nothing)."""
    from deep_tracking_control_tpu_torch.env import config as pc
    from deep_tracking_control_tpu_torch.tasks import registry
    from reference.dtc.env import config as rc
    entry = {c["name"]: c for c in m["configs"]}[name]
    assert entry["file"].startswith(tuple(p + "/" for p in m["paths"]))
    assert entry["reduced"] == [] and entry["source"].startswith("https://")
    data = json.loads((manifest.ROOT / entry["file"]).read_text())
    task, train = registry.get_cfgs(name)
    assert hc.build(pc.TaskCfg, data["task"]) == task
    assert hc.build(pc.TrainCfg, data["train"]) == train
    assert hc.to_data(hc.build(rc.TaskCfg, data["task"])) == data["task"]
    assert data["task"]["env"]["num_envs"] == 4096


def test_build_rejects_partial_files():
    from deep_tracking_control_tpu_torch.env import config as pc
    data = hc.to_data(pc.TaskCfg())
    del data["env"]["num_envs"]
    with pytest.raises(ValueError, match="num_envs"):
        hc.build(pc.TaskCfg, data)
    data = hc.to_data(pc.TaskCfg())
    data["terrain"]["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        hc.build(pc.TaskCfg, data)
