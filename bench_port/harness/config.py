"""Configuration files as data: a frozen dataclass tree to and from the
JSON that bench_port/configs/<name>.json holds.

`build` takes the dataclass types from whichever package asks (the port's
env/config.py for the system under test, the reference's copy for the
reference), so both sides are built from the file and neither from the
other's registry."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path


def to_data(cfg):
    """A dataclass tree as plain JSON values (tuples become lists)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def build(cls, data: dict, where: str = ""):
    """An instance of dataclass `cls` holding exactly the fields of `data`:
    a field missing from the file, or a key the class lacks, raises, so a
    file states its whole configuration.  Nested dataclasses are read from
    the type of the field's default."""
    base = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    missing, extra = names - set(data), set(data) - names
    if missing or extra:
        raise ValueError(f"{where or cls.__name__}: missing {sorted(missing)}"
                         f", unknown {sorted(extra)}")
    kw = {}
    for k, v in data.items():
        cur = getattr(base, k)
        if dataclasses.is_dataclass(cur):
            kw[k] = build(type(cur), v, f"{where}.{k}" if where else k)
        else:
            kw[k] = _tuples(v)
    return dataclasses.replace(base, **kw)


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def task_and_train(cfg_file: dict, task_cls, train_cls, num_envs: int,
                   seed: int):
    """(TaskCfg, TrainCfg) of `cfg_file` with the mix's env count and the
    run's seed (the runner's and, as scripts/train.py does, the terrain's);
    the file's other fields as stated."""
    task = build(task_cls, cfg_file["task"], "task")
    train = build(train_cls, cfg_file["train"], "train")
    task = dataclasses.replace(task, env=dataclasses.replace(
        task.env, num_envs=num_envs))
    train = dataclasses.replace(train, runner=dataclasses.replace(
        train.runner, seed=seed))
    return task, train
