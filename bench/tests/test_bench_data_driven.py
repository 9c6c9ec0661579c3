"""A cell, a configuration, a traffic mix and a per-layer metric are added
as files and entries, with no edit to a file that is there: a copy of
the benchmark with such additions finds them."""
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

PROBE = """
import json
from bench import harness
sp = harness.spec()
c = harness.cell(sp, "h2o-danube-1.8b-x.train-4k")
ctx = {"kind": "train", "window_steps": 3, "window_s": 1.5}
print(json.dumps({
    "config": c["config"]["n_layers"], "seq": c["traffic"]["seq_len"],
    "limits": c["limits"], "loop": c["traffic"]["loop"],
    "metrics": [m["name"] for m in harness.per_layer(sp, c["workload"]["name"])],
    "read": harness.read_metrics([m for m in sp["per_layer"]
                                  if m["name"] == "steps_in_window"], ctx),
}))
"""


def test_added_files_are_found(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "h2o-danube-1.8b.json").read_text())
    cfg.update(name="h2o-danube-1.8b-x", n_layers=12, reduced=["n_layers"])
    (b / "configs" / "h2o-danube-1.8b-x.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "train-16k.json").read_text())
    (b / "traffic" / "train-4k.json").write_text(
        json.dumps(dict(tr, seq_len=512)))
    (b / "limits" / "h2o-danube-1.8b-x.train-4k.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (b / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return ctx.get('window_steps')\n")
    spec["configs"].append(dict(spec["configs"][0], name="h2o-danube-1.8b-x",
                                file="bench/configs/h2o-danube-1.8b-x.json"))
    spec["workloads"].append({"name": "h2o-danube-1.8b-x.train-4k",
                              "config": "h2o-danube-1.8b-x",
                              "traffic": "train-4k", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "step loop", "moves":
                              "train_tokens_per_s",
                              "workloads": ["h2o-danube-1.8b-x.train-4k"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("h2o-danube-1.8b-x.train-4k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["config"] == 12 and got["seq"] == 512
    assert got["limits"] == {"loss_gap": 1.0} and got["loop"] == "train"
    assert "steps_in_window" in got["metrics"]
    assert got["read"]["steps_in_window"] == {"value": 3, "unit": "steps"}
