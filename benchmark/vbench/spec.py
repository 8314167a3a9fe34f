"""The benchmark's data, found by name: the cell in ``BENCHMARK.json``, its
configuration file under ``benchmark/configs/``, its traffic mix under
``benchmark/traffic/``, its limits under ``benchmark/limits/`` and the
readers of its per-layer metrics under ``benchmark/metrics/``.  A later cell,
mix, configuration or metric is a new file here, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # number compared -> its limit
    end_to_end: list       # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list        # ... per_layer entries


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _load(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def build_config(config_module, fields: dict):
    """``config_module.VloamConfig`` from the configuration file's
    ``vloam`` object.  Every field must be given, and no other: the file
    holds the configuration as it is run."""
    def make(cls, d):
        names = {f.name: f for f in dataclasses.fields(cls)}
        if set(d) != set(names):
            raise ValueError(f"{cls.__name__}: missing {sorted(set(names) - set(d))}, "
                             f"unknown {sorted(set(d) - set(names))}")
        kw = {}
        for key, value in d.items():
            sub = getattr(config_module, type(getattr(cls(), key)).__name__, None) \
                if isinstance(value, dict) else None
            kw[key] = make(sub, value) if sub is not None else value
        return cls(**kw)
    return make(config_module.VloamConfig, fields)


def metric_reader(name: str):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
