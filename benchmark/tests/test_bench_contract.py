"""BENCHMARK.json keeps the shape the benchmark's checker reads: its keys,
names, units and bounds, every cell's files, and what each cell reports."""

from __future__ import annotations

import json
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        body = json.loads((REPO / c["file"]).read_text())
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    cells = BENCH["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (REPO / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
    assert {c["config"] for c in cells} == set(names)


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def _reports_layer(metric, cell, e2e_names):
    """Without ``workloads``, a per-layer metric is reported wherever the
    end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    all_names = [m["name"] for m in e2e + per]
    assert len(set(all_names)) == len(all_names)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] == 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in e2e if _reports(m, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in per if _reports_layer(m, w["name"], mine)]
        assert layer and all(m["moves"] in mine for m in layer)
        assert any("mfu" in m["name"] for m in layer)


def test_metric_modules_declare_what_benchmark_json_says():
    from benchmark.core.cell import reader

    for m in BENCH["per_layer"]:
        mod = reader(REPO, m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
