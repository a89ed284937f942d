"""BENCHMARK.json against the contract's shape, and every name in it
backed by a file the harness finds by that name."""
import json
import os
import re

import pytest

SB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(SB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["slambench"] and bench["command"][1] == "slambench/run.py"
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[sec]]
        assert len(set(names)) == len(names)
        for e in bench[sec]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        with open(os.path.join(SB, "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        with open(os.path.join(SB, "traffic", w["traffic"] + ".json")) as f:
            tr = json.load(f)
        assert os.path.exists(os.path.join(SB, "generators", tr["generator"] + ".py"))
        assert wl["check"]["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(SB, "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and pl
