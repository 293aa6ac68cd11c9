"""The control on the card at the tiny size: the reference, put in the
program's place a step below the configuration's precision (TF32 for the
float32 parts, fp8 weights for the bf16 decode), comes out as not correct
against the cell's own limits, where the program comes out correct. The
limits come from readings at the cells' own size
(``python3 -m portbench.control``, PERF.md)."""
import pytest
import torch

from portbench import run
from portbench.tests.tiny import overrides


@pytest.mark.card
@pytest.mark.parametrize("workload", ["xyz-grid", "xyz-train-held"])
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card: the control reads as the program on the CPU")
    result = run.execute(["--workload", workload, "--seed", "4294967313", "--seconds", "0",
                          "--trace", "0"], overrides=overrides,
                         variants={"control": {"precision": "control"}})
    program, control = result["readings"]["program"], result["readings"]["control"]
    assert program["correct"] and result["correct"], program
    assert not control["correct"], (program, control)
