"""The benchmark's arithmetic against hand counts and against
``torch.utils.flop_counter`` on the reference at a reduced size."""
import json
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import flops as FL
from bench.reference import model as RM
from bench.tests.tiny import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_kernel_bytes_by_hand():
    # bf16 g 2 B + f8 e 1 B in; payload 0.5 B + f8 e 1 B + scales 4/256 out
    assert FL.compress_bytes(512) == 512 * 2 + 512 + 256 + 512 + 8
    assert FL.compress_bytes(1 << 20) == pytest.approx(4.515625 * (1 << 20))
    # D payload rows of 0.5 B and their scales in, a bf16 mean out
    assert FL.dequant_bytes(512) == 256 + 8 + 1024
    assert FL.dequant_bytes(512, D=4) == 4 * (256 + 8) + 1024


def test_pairs_by_hand():
    assert FL.pairs(4, 10) == 1 + 2 + 3 + 4
    assert FL.pairs(6, 3) == 1 + 2 + 3 + 3 + 3 + 3
    assert FL.pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_published_counts():
    m, d = config("mixtral-8x7b-1l"), config("h2o-danube-1.8b")
    # attention 2*4096*4096 + 2*4096*1024, experts 2 of 3*4096*14336, router
    assert FL.params_per_token(m) == (2 * 4096 * 4096 + 2 * 4096 * 1024
                                      + 2 * 3 * 4096 * 14336 + 4096 * 8,
                                      4096 * 32000)
    assert FL.params_per_token(d) == (2 * 2560 * 2560 + 2 * 2560 * 640
                                      + 3 * 2560 * 6912, 2560 * 32000)
    # every leaf: 1,713,418,240 and 1,831,201,280 parameters (PERF.md)
    for c, n in ((m, 1_713_418_240), (d, 1_831_201_280)):
        assert sum(lf.numel * lf.rows for lf in RM.leaves(c)) == n
    t = json.loads((BENCH / "traffic" / "train-16k.json").read_text())
    assert len(FL.loco_lengths(d, t)) == 2 + 24 * 7


@pytest.mark.parametrize("workload", ["h2o-danube-1.8b.train-16k",
                                      "mixtral-8x7b.train-8k"])
def test_flops_against_flop_counter(workload):
    """The reference's forward, counted by torch, less the masked pairs
    its blocks compute, is a third of a step's model FLOPs."""
    c = dict(tiny(workload)["config"], capacity_factor=8.0)  # none dropped
    B, S = 2, 64
    W = {(lf.group, lf.name): torch.randn(
        ((lf.layers,) if lf.layers else ()) + lf.shape)
        for lf in RM.leaves(c)}
    toks = torch.randint(0, c["vocab"], (B, S + 1))
    with FlopCounterMode(display=False) as fc:
        dec = RM.Decoder(c)
        dec.mm(dec.hidden(W, toks[:, :-1])[0], W[("final", "head")])
    masked = S * S - FL.pairs(S, c["window"])
    computed = 4 * c["n_heads"] * c["head_dim"] * masked * c["n_layers"] * B
    assert 3 * (fc.get_total_flops() - computed) == \
        FL.train_step_flops(c, S, B)
