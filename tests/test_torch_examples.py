"""The port's quickstart example (``examples/quickstart_torch.py``) on the
CPU: 4 spawned gloo ranks at the reference's dp 2 x tp 2, a few steps of
LoCo 4-bit training of reduced llama2-400m; the loss is finite and falls.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_trains_on_a_2x2_gloo_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--steps", "6", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: dp 2 x tp 2 on cpu" in out.stdout
    losses = [float(x) for x in re.findall(r"loss (\S+)", out.stdout)]
    assert len(losses) == 6, out.stdout
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.3, losses
    assert "done -- gradients were synchronized" in out.stdout
