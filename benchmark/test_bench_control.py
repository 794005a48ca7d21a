"""Each configuration's control, the step below its stated precision, comes
out not correct, where the program itself does (at the small size).

LightGCN's control is the reference computed in TF32 in the program's
place, which a CPU can compute; KHGRec's is the program's own int8
gathered operand (kernels 3 and 4), which runs on a card only."""

import pytest
import torch

from harness.small import run_small


@pytest.mark.parametrize("cell", ["lightgcn-amazonbook.train", "lightgcn-amazonbook.eval"])
def test_the_tf32_reference_in_the_programs_place_is_not_correct(cell):
    torch.set_num_threads(1)
    assert run_small(cell)["correct"] is True
    r = run_small(cell, control="reference")
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["khgrec-ml1m.train"])
def test_the_int8_program_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the int8 kernels run on a CUDA card only")
    assert run_small(cell, device="cuda")["correct"] is True
    r = run_small(cell, device="cuda", control="program_env")
    assert r["correct"] is False, r["checks"]
