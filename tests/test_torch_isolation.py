"""The port stands alone: it imports neither ``jax`` nor the reference
package ``repro``, and its entry points never fall back to the CPU quietly.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro", "jaxlib", "ml_dtypes")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_port_module_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_train_without_gpu_or_cpu_flag_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "llama2-400m", "--reduced", "--steps", "1"])


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_checkpoint_round_trip_without_jax_or_ml_dtypes(tmp_path):
    """The card's machine has neither ``jax`` nor ``ml_dtypes``: with both
    made unimportable, the overlap schedule and the checkpoint layer
    import, and a bf16/f8 state saves and restores byte for byte."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch.core import wirepack\n"
        "from repro_torch.checkpoint import checkpoint as C\n"
        "from repro_torch.state import logical, manifest, reshard, serial\n"
        "assert wirepack.build_overlap_schedule\n"
        "x = {'a': torch.randn(3, 512).to(torch.float8_e4m3fn),\n"
        "     'b': (torch.randn(2, 7).to(torch.bfloat16),\n"
        "           torch.arange(5, dtype=torch.float32))}\n"
        f"C.save({str(tmp_path)!r}, 1, x)\n"
        f"assert C.latest_step({str(tmp_path)!r}) == 1\n"
        f"y = C.restore({str(tmp_path)!r}, 1, x)\n"
        "for k, v in serial.flatten(x).items():\n"
        "    w = serial.flatten(y)[k]\n"
        "    assert w.dtype == v.dtype and w.shape == v.shape, k\n"
        "    assert torch.equal(w.reshape(-1).view(torch.uint8),\n"
        "                       v.reshape(-1).view(torch.uint8)), k\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
