"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file of the harness (CPU)."""
import json
import math
import os
import re

import pytest

import sdpbench_cells as sc
import harness

BENCH = json.load(open(os.path.join(sc.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(sc.ROOT, p))
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # the full check at 24 cells fits into 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_every_name_and_unit_uses_the_allowed_characters():
    kinds = ("configs", "workloads", "end_to_end", "per_layer")
    names = [e["name"] for k in kinds for e in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[k]]
        assert len(got) == len(set(got)), k
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_configs_workloads_and_metrics():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("sdpbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.load(open(os.path.join(sc.ROOT, c["file"])))
        assert data["reduced"] == c["reduced"] and data["assumed"] == []
        assert os.path.exists(os.path.join(sc.ROOT, data["instance"]))
        assert data["guarantee"]["status"] == "OPTIMAL"
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(sc.SDPBENCH, "workloads", f"{w['name']}.json"))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(sc.SDPBENCH, "metrics", f"{m['name']}.py")), m["name"]
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one
        mine = lambda k: [m for m in BENCH[k] if cell in m.get("workloads", cells)]  # noqa: E731
        assert "setup_s" in {m["name"] for m in mine("end_to_end")} and len(mine("end_to_end")) >= 2
        assert mine("per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    import harness

    c = harness.load_cell(cell)
    limits = c.limits()
    assert limits["not_optimal"] == 0 and limits["dimacs"] == c.config["guarantee"]["eDIMACS"]
    assert all(math.isfinite(v) and v >= 0 for v in limits.values())


def test_a_workload_key_the_harness_does_not_know_is_refused(monkeypatch):
    real = harness.load_json

    def with_clients(path):
        d = real(path)
        return {**d, "clients": 4} if os.path.basename(os.path.dirname(path)) == "workloads" else d

    monkeypatch.setattr(harness, "load_json", with_clients)
    with pytest.raises(SystemExit, match="clients"):
        harness.load_cell(BENCH["workloads"][0]["name"])
