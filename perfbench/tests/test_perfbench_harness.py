"""The harness finds each cell, configuration, traffic, limit and metric by
its name in BENCHMARK.json, and BENCHMARK.json keeps to the shape the
benchmark's contract sets."""

import json
import os
import re

import pytest

from perfbench import core

ROOT = core.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = core.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["driver"] in ("design", "sft")
    assert os.path.exists(os.path.join(core.PB, "drivers",
                                       f"{c.traffic['driver']}.py"))
    assert set(c.limits)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(core.load_reader(metric))


def test_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.add(m["layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        core.Cell("no-such-cell")


def test_no_card_no_result(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        core.check_device(1)
