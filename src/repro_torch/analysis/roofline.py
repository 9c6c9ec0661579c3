"""Roofline terms of one step on one H100 (port of
``repro.analysis.roofline``).

Per (arch x shape x mesh) the dry run (``launch/dryrun``) counts, per
device, the step's dot FLOPs, its HBM bytes and its wire bytes
(``analysis/op_stats``), and turns them into three times:

  compute term    = FLOPs / PEAK_FLOPS
  memory term     = HBM bytes / HBM_BW
  collective term = wire bytes / LINK_BW

The largest is the step's ``dominant`` term, as in the reference.  The
constants are the H100 SXM5's in place of the reference's TPU v5e ones;
the wire bytes per device follow the reference's (N-1)/N accounting
(``op_stats.collective_wire``).
"""
from __future__ import annotations

# dense BF16 tensor-core peak of the H100 SXM5 (NVIDIA H100 Tensor Core
# GPU datasheet: 1,979 TFLOPS with 2:4 sparsity, half of it dense)
PEAK_FLOPS = 989.4e12
# HBM3 bandwidth of the H100 SXM5 (the same datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
# one GPU's inter-node link: a 400 Gb/s InfiniBand NDR port (ConnectX-7,
# one per GPU in a DGX H100), 50e9 B/s each way; it takes the place of
# the reference's one ICI link
LINK_BW = 50e9
# device memory of the H100 80GB HBM3, as the card reports it
# (torch.cuda.get_device_properties(0).total_memory, printed and checked by
# chip_smoke.py's dryrun phase): the report's fit mark
HBM_BYTES = 85_017_493_504


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float) -> dict:
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = wire_bytes / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    denom = max(t_compute, t_memory, t_coll)
    terms["compute_fraction_of_roofline"] = t_compute / denom if denom else 0.0
    return terms


def model_flops_per_step(n_params_active: float, tokens: float) -> float:
    """6 * N * D rule (per optimizer step; D = tokens processed)."""
    return 6.0 * n_params_active * tokens
