"""Everything of a cell, found by name in files of its own.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic mix, and the metrics. Under ``fedbench/``:

- ``configs/<config>.json`` (the entry's ``file``): the model's sizes as
  run, its ``model`` family, the recipe and the learning rate;
- ``traffic/<mix>.json``: the mix (``fedbench/traffic.py``), which may
  name a mix it ``extends`` and the keys it sets anew;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
  returning a number or None;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``reference/<model>.py`` and ``program/<model>.py``: the plain
  reference of a model family and the program's build of it.

A later cell or metric adds files and entries; it edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parent.parent
PKG = "fedbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: Path

    @property
    def model(self) -> str:
        return self.config["model"]

    @property
    def recipe(self) -> dict:
        """The configuration's recipe and the mix's (the compression
        mode); each flag is set by one of the two."""
        conf, mix = self.config["recipe"], self.traffic.get("recipe", {})
        both = sorted(set(conf) & set(mix))
        if both:
            raise ValueError(f"{both} set by both the configuration and "
                             "the traffic mix")
        return {**conf, **mix}


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def mix(name: str, root: Path = ROOT) -> dict:
    """The traffic mix ``name``, over the mix it ``extends``, if any."""
    out = _json(root / PKG / "traffic" / f"{name}.json")
    base = out.pop("extends", None)
    return out if base is None else {**mix(base, root), **out}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / conf["file"]),
        traffic=mix(w["traffic"], root),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=_json(root / PKG / "limits" / f"{name}.json"), root=root)


def reader(c: Cell, metric: str) -> ModuleType:
    return load_module(c.root / PKG / "metrics" / f"{metric}.py",
                       f"fedbench_metric_{metric}")


def reference(c: Cell) -> ModuleType:
    return load_module(c.root / PKG / "reference" / f"{c.model}.py",
                       f"fedbench_reference_{c.model}")


def program(c: Cell) -> ModuleType:
    return load_module(c.root / PKG / "program" / f"{c.model}.py",
                       f"fedbench_program_{c.model}")
