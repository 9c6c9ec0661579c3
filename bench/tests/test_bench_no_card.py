"""Without a card the harness fails: a non-zero exit and no result line,
never a fall-back to the CPU; and in a directory that holds only
``BENCHMARK.json`` and the benchmark's files, it fails too."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
ARGS = ["--workload", "mixtral-8x7b.train-8k", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: a run would measure it")


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_no_card_no_result(no_card):
    r = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "CUDA" in r.stderr


def test_benchmark_files_alone_no_result(no_card, tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_result(r.stdout)
