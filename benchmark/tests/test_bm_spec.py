"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files."""

import json
import os
import re

import pytest

from conftest import ROOT

SPEC = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    with open(SPEC) as fh:
        return json.load(fh)


def test_keys(spec):
    assert set(spec) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") \
                else set()
            assert KEYS[part] <= set(entry) <= KEYS[part] | extra, entry


def test_names_and_units(spec):
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[part]:
            assert NAME.match(e["name"]), e["name"]
            names.append((part, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for e in spec["configs"]:
        assert all(NAME.match(k) for k in e["reduced"])
        assert len(e["reduced"]) <= 16
    for e in spec["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
    for text in ([e["why"] for p in ("configs", "workloads")
                  for e in spec[p]]
                 + [e["source"] for e in spec["configs"]]
                 + [e["layer"] for e in spec["per_layer"]]
                 + spec["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text
    assert os.path.getsize(SPEC) <= 64 * 1024


def test_paths_and_command(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(spec["command"]) <= 32
    script = spec["command"][1]
    assert any(script.startswith(p + "/") for p in spec["paths"])
    assert 1 <= spec["run_seconds"] <= 51


def test_bounds_and_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in spec["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


def test_chips(spec):
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in spec["workloads"])
    assert len(four) <= max(1, len(spec["workloads"]) // 4)


def test_every_cell_resolves(spec):
    from benchmark import cell
    files = set()
    for c in spec["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        with open(path) as fh:
            conf = json.load(fh)
        assert set(c["reduced"]) == set(conf["reduced"]), c["name"]
        assert c["file"] not in files
        files.add(c["file"])
    used = set()
    for w in spec["workloads"]:
        c = cell.Cell(w["name"])
        used.add(w["config"])
        c.reference()
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "genomes",
            c.config["genome"]["generator"] + ".py"))
        for m in c.per_layer + c.end_to_end:
            assert callable(c.reader(m["name"]).read)
        assert c.traffic["name"] == w["traffic"]
    assert used == {c["name"] for c in spec["configs"]}
