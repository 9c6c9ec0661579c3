"""The training slice under the schedule and codec knobs of the CLI,
against the JAX reference (CPU, reduced llama2-400m, dp 2): ``--schedule
wsd``, ``--quant-mode fixed``, ``--quant-mode tensor --error-codec bf16``
and ``--error-codec none``, each within the loss limits of the
reference's losses (the harness of ``tests/test_torch_optim_train.py``).
On the CPU every one of these cells runs the codec's plain ops, as on the
card, where the reference registers no kernel for them either.
"""
import pytest

from test_torch_optim_train import check_case, run_cases

KNOB_CASES = ("wsd", "fixed", "tensor-bf16", "error-none")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(KNOB_CASES, tmp_path_factory.mktemp("knobs"))


@pytest.mark.parametrize("case", KNOB_CASES)
def test_knob_matches_reference(runs, case):
    check_case(runs, case)
