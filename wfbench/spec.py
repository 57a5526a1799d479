"""Finding a cell's files by name: ``BENCHMARK.json`` at the repository
root, ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json`` beside this file.

A later cell, mix, configuration or metric is added by adding its files and
its entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the configuration file's keys that are not NPSConfig fields
CONFIG_META = ("source", "reduced", "assumed")


class SpecError(ValueError):
    """A cell, file or entry that the benchmark cannot find or read."""


def _load_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


class Geometry:
    """Attribute view of a configuration's fields with the derived sizes the
    generators and the reference need (the formulas of NPSConfig's
    properties, kept here so the yardstick does not move with the
    program)."""

    def __init__(self, fields: dict):
        self.__dict__.update(fields)

    @property
    def nblocks(self) -> int:
        return self.ncol * self.nlin

    @property
    def mfwidth(self) -> int:
        return self.mfleft + self.mfright + 1

    @property
    def nfitbins(self) -> int:
        return self.fit_hi_bin - self.fit_lo_bin

    def timerefacc(self) -> float:
        return (self.calodist - 9.5) / (3.0e8 * 1.0e-9 * self.dt)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config_name: str
    fields: dict          # NPSConfig fields as the configuration file states
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    @property
    def geometry(self) -> Geometry:
        return Geometry(self.fields)

    @property
    def dtype_name(self) -> str:
        return self.fields["compute_dtype"]


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config_fields(name: str) -> dict:
    """NPSConfig fields of ``configs/<name>.json`` (its meta keys left out)."""
    data = _load_json(os.path.join(HERE, "configs", f"{name}.json"))
    return {k: v for k, v in data.items() if k not in CONFIG_META}


def traffic(name: str) -> dict:
    data = _load_json(os.path.join(HERE, "traffic", f"{name}.json"))
    if data.get("entry") not in ("run_segment", "process_batch"):
        raise SpecError(f"traffic/{name}.json: entry must be run_segment or "
                        f"process_batch, not {data.get('entry')!r}")
    return data


def limits(cell: str) -> Dict[str, float]:
    data = _load_json(os.path.join(HERE, "limits", f"{cell}.json"))
    return {k: float(v["limit"]) for k, v in data.items()}


def load_reader(name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no reader metrics/{name}.py for metric {name}")
    spec = importlib.util.spec_from_file_location(
        "wfbench_metric_" + name.replace(".", "_"), path)
    mod: ModuleType = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metrics/{name}.py has no read(ctx)")
    return mod.read


def cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files read; an unknown
    name raises SpecError."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SpecError(f"unknown workload {name!r} (BENCHMARK.json has "
                        f"{known})")
    w = found[0]
    if not any(c["name"] == w["config"] for c in bench["configs"]):
        raise SpecError(f"workload {name} names config {w['config']}, which "
                        f"BENCHMARK.json does not list")

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    for m in layer:
        load_reader(m["name"])
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                fields=config_fields(w["config"]),
                traffic_name=w["traffic"], traffic=traffic(w["traffic"]),
                end_to_end=e2e, per_layer=layer, limits=limits(name))
