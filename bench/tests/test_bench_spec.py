"""``BENCHMARK.json`` against the form its readers expect, and every name
in it against the files the harness finds by that name."""
import json
import math
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|head_dim|top_k|vocab|"
                   r"ssm_state|expand)$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "bench/run.py"]
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    need = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 + 1200
    assert need <= 43200


def test_names_units_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        f = ROOT / c["file"]
        cfg = json.loads(f.read_text())
        assert c["file"].startswith("bench/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert cfg["source"] == c["source"]


def test_every_cell_has_its_files_and_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    assert {w["config"] for w in SPEC["workloads"]} == configs
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(cells)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        t = json.loads((ROOT / "bench" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        assert (ROOT / "bench" / "loops" / f"{t['loop']}.py").exists()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists()
        mine = [m for m in e2e.values()
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in SPEC["per_layer"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert math.isfinite(SPEC["run_seconds"])


def test_limits_name_the_compared_numbers():
    for w in SPEC["workloads"]:
        lim = json.loads((ROOT / "bench" / "limits"
                          / f"{w['name']}.json").read_text())
        want = ({"token_gap"} if "serve" in w["traffic"]
                else {"loss_gap", "grad1_gap", "change_gap"})
        assert set(lim) == want and all(v > 0 for v in lim.values())
