"""Compile the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built at first use into ``_build/`` next to this file (listed in
``.gitignore``) under a name keyed on a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is not.  Libraries load
with ``ctypes``; no PyTorch headers are compiled, which keeps a build to
seconds.  ``build_all`` starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so no multiply-add is
contracted behind the source's back, and never ``--use_fast_math``: the
kernels must match their plain PyTorch versions bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: where its library is and what nvcc said."""

    name: str
    path: Path
    seconds: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc/ptxas output (registers, spills) of this build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU, which has the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Built]:
    """Build every named source (default: all of ``csrc/*.cu``) that has no
    up-to-date library yet, one ``nvcc`` process per source in parallel."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: dict[str, Built] = {}
    running = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            done[name] = Built(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: no reader sees half a file
        done[name] = Built(name, out, secs, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(str(build_all([name])[name].path))
