"""The control on the card: the reference in the program's place, in the
next precision below the configuration's (its `correct.control`), fails
the limits that sound runs of the program meet. Runs one cell's program
for a short window at its full size and reads both (`control.py`);
skips without a CUDA device."""
import pytest

from cosine_bench import control, spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_control_fails_where_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA device")
    r = control.readings(spec.load(), cell, 20240917, 10.0)
    limits = r["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items())
    assert any(r[r["control"]][k] > v for k, v in limits.items())
