"""Finding a cell's parts by name: `BENCHMARK.json` at the checkout's root
names each cell's configuration and traffic mix; the files beside this one
hold them (`configs/<config>.json`, `mixes/<traffic>.json`,
`limits/<cell>.json`) and the code of each query, reference, generator and
per-layer metric (`queries/<q>.py`, `reference/<q>.py`, `gen/<g>.py`,
`metrics/<m>.py`). Adding any of them needs no edit here."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
import threading
from dataclasses import dataclass
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: A name of a cell, metric or configuration: a letter, digit or _, then letters, digits, _, . and -.
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_LOADING = threading.Lock()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One entry of `workloads` with its configuration, mix and limits."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    bench = bench or benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return assemble(name, int(entry["chips"]), conf["file"], entry["traffic"],
                    [m for m in bench["end_to_end"] if _applies(m, name)],
                    [m for m in bench["per_layer"] if _applies(m, name)], root)


def assemble(name: str, chips: int, config_file: str, traffic: str, end_to_end: List[dict],
             per_layer: List[dict], root: str = ROOT) -> Cell:
    """A cell from its files: the configuration, `mixes/<traffic>.json` and
    `limits/<name>.json`."""
    return Cell(
        name=name,
        chips=chips,
        config=load_json(os.path.join(root, config_file)),
        mix=load_json(os.path.join(root, "lakebench", "mixes", traffic + ".json")),
        limits=load_json(os.path.join(root, "lakebench", "limits", name + ".json")),
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def module(kind: str, name: str):
    """`<kind>/<name>.py` under the `lakebench.<kind>` package's directories,
    loaded as `lakebench.<kind>.<name>`: kind is queries, reference, gen or
    metrics. A name may hold dots (a metric's name is its file's)."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    key = f"lakebench.{kind}.{name}"
    with _LOADING:  # the streams' threads ask at once: none may see a half-run module
        return sys.modules.get(key) or _load(kind, name, key)


def _load(kind: str, name: str, key: str):
    pkg = importlib.import_module(f"lakebench.{kind}")
    for d in pkg.__path__:
        path = os.path.join(d, name + ".py")
        if os.path.exists(path):
            found = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(found)
            mod.__package__ = pkg.__name__
            sys.modules[key] = mod
            try:
                found.loader.exec_module(mod)
            except BaseException:
                del sys.modules[key]
                raise
            return mod
    raise ModuleNotFoundError(f"no {kind}/{name}.py")
