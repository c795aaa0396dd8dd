"""BENCHMARK.json against the rules of its format, and the data-driven
layout: a new mix, query, reference or metric is a new file found by name."""

import json
import os
import re
import shutil
import sys

import pytest
from conftest import CELLS, ROOT, tiny_cell

from lakebench import spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_the_file_has_its_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["lakebench"] and bench["command"] == ["python3", "lakebench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    # A check of 24 cells, each run given run_seconds + 60 s and each cell 2 x 90 s
    # to compile, with 1,200 s spare, fits in 43,200 seconds.
    assert 1200 + (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lakebench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        conf = spec.load_json(os.path.join(ROOT, c["file"]))
        assert all(k in conf and NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "lakebench", "limits", w["name"] + ".json"))
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    all_names = names + [w["name"] for w in bench["workloads"]] + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in all_names) and len(set(all_names)) == len(all_names)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("name", CELLS)
def test_every_named_part_has_its_file(name):
    cell = tiny_cell(name)
    spec.module("gen", cell.config["generator"])
    for q in cell.mix["queries"]:
        spec.module("queries", q["query"])
        ref = spec.module("reference", q["query"])
        assert ref.COLUMNS == spec.module("queries", q["query"]).COLUMNS
    for m in cell.per_layer:
        assert callable(spec.module("metrics", m["name"]).read)
    assert set(cell.limits) == {"errors", "wrong_answers", "plan_misses", "measure_rel_err"}


def test_a_new_mix_is_found_by_its_name_with_no_edit(tmp_path, bench):
    root = tmp_path / "checkout"
    (root / "lakebench").mkdir(parents=True)
    for d in ("configs", "mixes", "limits"):
        shutil.copytree(os.path.join(ROOT, "lakebench", d), root / "lakebench" / d)
    mix = spec.load_json(os.path.join(ROOT, "lakebench", "mixes", "q3_streams3.json"))
    mix.update(name="q3_streams1", streams=1)
    (root / "lakebench" / "mixes" / "q3_streams1.json").write_text(json.dumps(mix))
    b = dict(bench)
    b["workloads"] = bench["workloads"] + [{"name": "tpch_sf10.q3_streams1", "config": "tpch_sf10",
                                           "traffic": "q3_streams1", "chips": 1, "why": "one stream"}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copy(os.path.join(ROOT, "lakebench", "limits", CELLS[0] + ".json"),
                root / "lakebench" / "limits" / "tpch_sf10.q3_streams1.json")
    cell = spec.cell("tpch_sf10.q3_streams1", root=str(root))
    assert cell.mix["streams"] == 1 and cell.config["name"] == "tpch_sf10"
    entry, params = next(traffic.stream_queries(cell.mix, 5, 0))
    assert entry["query"] == "tpch_q3" and set(params) == {"DATE", "SEGMENT"}


def test_a_new_query_reference_and_metric_are_found_by_name(tmp_path, monkeypatch):
    import lakebench.metrics
    import lakebench.queries
    import lakebench.reference

    for pkg, body in ((lakebench.queries, "COLUMNS = ['x']\ndef build(read, col, p):\n    return 'built'\n"),
                      (lakebench.reference, "COLUMNS = ['x']\n"),
                      (lakebench.metrics, "def read(run):\n    return 42.0\n")):
        d = tmp_path / pkg.__name__.split(".")[-1]
        d.mkdir()
        (d / "zz_added.py").write_text(body)
        monkeypatch.setattr(pkg, "__path__", list(pkg.__path__) + [str(d)])
    try:
        assert spec.module("queries", "zz_added").build(None, None, {}) == "built"
        assert spec.module("reference", "zz_added").COLUMNS == ["x"]
        assert spec.module("metrics", "zz_added").read(None) == 42.0
    finally:
        for kind in ("queries", "reference", "metrics"):
            sys.modules.pop(f"lakebench.{kind}.zz_added", None)


def test_param_draws_cover_their_ranges_and_repeat():
    mix = spec.load_json(os.path.join(ROOT, "lakebench", "mixes", "q3q55_streams3.json"))
    a = [p for _, p in zip(range(400), (p for _, p in traffic.stream_queries(mix, 9, 1)))]
    b = [p for _, p in zip(range(400), (p for _, p in traffic.stream_queries(mix, 9, 1)))]
    assert a == b
    q3 = a[::2] if "MANUFACT" in a[0] else a[1::2]
    assert {p["MONTH"] for p in a} == {11, 12} and all(1 <= p["MANUFACT"] <= 1000 for p in q3)
    warm = [p for _, p in zip(range(20), (p for _, p in traffic.stream_queries(mix, 9, 1, "warmup")))]
    assert warm != a[:20]


def test_every_seed_deals_the_same_combinations_in_another_order():
    mix = spec.load_json(os.path.join(ROOT, "lakebench", "mixes", "q3_streams3.json"))
    deck = 5 * 31  # SEGMENT x DATE

    def dealt(seed):
        return [tuple(sorted(p.items())) for s in range(3)
                for _, p in zip(range(deck), (p for _, p in traffic.stream_queries(mix, seed, s)))]

    a, b = dealt(1), dealt(2**31 + 7)
    assert a != b and sorted(a) == sorted(b)
    assert len(set(a)) == deck  # one stream's first pass holds each combination once
    firsts = [next(traffic.stream_queries(mix, 1, s))[1] for s in range(3)]
    assert len({tuple(sorted(p.items())) for p in firsts}) == 3  # the streams start apart
