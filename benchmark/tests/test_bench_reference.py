"""The plain reference agrees with ``mcax_torch`` (its plain versions on
the CPU, at a tiny size), and a run whose timed path is broken underneath
comes out not correct, once for each fault a cell can have.  The control
(the reference one precision below in the program's place) must come out
not correct at the cells' own sizes on the card."""

import time

import pytest
import torch

from harness import cells, runner

TINY = {"blocks_per_call": 2, "distinct_calls": 2, "checked_calls": 2}
SEED = 2**31 + 12345


def _run(cell, inject=None, overrides=TINY, seeds=(SEED,), control=False,
         device="cpu"):
    job = {"workload": cell, "seeds": list(seeds), "seconds": 0.5,
           "trace": False, "t_start": time.time(), "device": device,
           "overrides": dict(overrides), "inject": inject,
           "control": control}
    return runner.run_job(job)


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell,overrides", [
    ("config4.bulk", TINY),
    ("config5.bulk", TINY),
    ("config4.stream", {"distinct_calls": 6, "checked_calls": 3}),
])
def test_reference_agrees_with_the_port_on_the_cpu(cell, overrides):
    (res,) = _run(cell, overrides=overrides)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared"]["picks_off"]["value"] == 0
    assert res["compared"]["audio_err"]["value"] < 1e-4


@pytest.mark.parametrize("cell,fault", [
    ("config4.bulk", "faults:unchanged"),
    ("config4.bulk", "faults:half_batch"),
    ("config4.bulk", "faults:altered"),
    ("config5.bulk", "faults:unchanged"),
    ("config5.bulk", "faults:half_batch"),
    ("config5.bulk", "faults:altered"),
    ("config5.bulk", "faults:confidence_blocks"),
    ("config5.bulk", "faults:confidence_carried"),
    ("config4.stream", "faults:unchanged"),
    ("config4.stream", "faults:altered"),
])
def test_a_broken_step_is_not_correct(cell, fault):
    overrides = (TINY if cell != "config4.stream"
                 else {"distinct_calls": 6, "checked_calls": 3})
    (res,) = _run(cell, inject=fault, overrides=overrides)
    assert res["correct"] is False, res["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["config4.bulk", "config5.bulk",
                                  "config4.stream"])
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    results = _run(cell, overrides={}, seeds=(SEED, SEED + 1, SEED + 2),
                   control=True, device="cuda")
    for res in results:
        assert res["correct"] is False, res["compared"]
