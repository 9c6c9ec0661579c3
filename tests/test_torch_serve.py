"""The port's serving steps and CLI on the CPU: a port of
``tests/test_smoke_archs.py::test_prefill_and_decode`` for every config
of ``ASSIGNED`` (reduced; batch 4, prompt 64, 2 decode steps: finite
logits, tokens in ``[0, vocab + tp)``), ``repro_torch.launch.serve`` with
``--device cpu``, and its refusal to fall back to the CPU without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.all_archs import ASSIGNED
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import flatparam as FP
from repro_torch.core.flatparam import MeshTopo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps

CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_prefill_and_decode(arch):
    cfg = reduced(get_arch(arch))
    Bt, S = 4, 64
    with tmesh.dp_group(CPU):
        topo = MeshTopo.from_group(*tmesh.mesh_groups(1))
        params = FP.init_serve_params(tsteps.model_groups(cfg, 1), 1, 0, CPU,
                                      seed=1)
        batch = ({"frames": torch.zeros(Bt, S, cfg.d_model,
                                        dtype=torch.bfloat16)}
                 if cfg.enc_dec else
                 {"tokens": torch.ones(Bt, S, dtype=torch.int64)})
        prefill = tsteps.make_prefill_step(
            cfg, topo, CPU, batch=Bt,
            window=tsteps.serve_window(cfg, S, 2))
        decode = tsteps.make_decode_step(cfg, topo, CPU)
        logits, state = prefill(params, batch)
        assert torch.isfinite(logits.float()).all()
        tok = torch.ones(Bt, 1, dtype=torch.int64)
        for _ in range(2):
            tok, logits, state = decode(params, state, tok)
            assert torch.isfinite(logits.float()).all()
    assert tok.shape == (Bt, 1)
    assert ((tok >= 0) & (tok < cfg.vocab + topo.tp)).all()


def test_serve_cli_on_cpu():
    """``serve.main`` returns its dict: one token from the prefill and one
    per decode step for each row, the cache sized to the whole generation,
    no kernel launched on the CPU; a second run repeats the tokens."""
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--prompt-len", "16",
            "--decode-steps", "3", "--batch", "2", "--device", "cpu"]
    res = serve.main(argv)
    assert res["window"] == 19
    assert np.array(res["tokens"]).shape == (2, 4)
    assert len(res["step_ms"]) == 3
    assert res["prefill_tok_per_s"] > 0 and res["decode_tok_per_s"] > 0
    assert res["launches"] == {"prefill": {}, "decode": {}}
    assert res["peak_mem_bytes"] is None
    assert serve.main(argv)["tokens"] == res["tokens"]


def test_serve_without_gpu_or_cpu_flag_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "llama2-400m", "--reduced"])
