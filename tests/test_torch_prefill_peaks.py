"""The port's serving prefill of the reference's ``prefill_32k`` cell
(two sequences of 32,768 tokens; whisper-small: 32,768 frames) at the
production mesh, 16 x 16, on fake CPU tensors (``launch.dryrun``): its
peak memory per device under the reference's.

The reference's peaks are its compiled steps' memory analyses on this
repository's CPU (PERF.md section 5): llama2-400m 1.39 GiB, mamba2-2.7b
2.83, zamba2-2.7b 3.48, whisper-small 1.25.  The port's before the
prefill took 512-key blocks, the conv caches their own storage and the
SSD scan its groups of chunks: 29.83, 5.34, 5.08 and 20.61 GiB; after,
1.30, 2.33, 2.55 and 1.23.  The state-space cases take some 25 s each of
host time, which is why they sit in a file of their own.
"""
import pytest

from repro_torch.launch import dryrun as DR

REF_PREFILL_32K_GIB = {"llama2-400m": 1.39, "mamba2-2.7b": 2.83,
                       "zamba2-2.7b": 3.48, "whisper-small": 1.25}


@pytest.mark.parametrize("arch", sorted(REF_PREFILL_32K_GIB))
def test_production_prefill_32k_fits_under_the_references(arch):
    """Full width and depth at 16 x 16 on fake CPU tensors: the prefill
    step's peak per device is under the reference's."""
    rec = DR.dryrun_one(arch, "prefill_32k", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16"
    peak = rec["memory"]["peak_bytes"] / 2**30
    assert peak < REF_PREFILL_32K_GIB[arch], peak
