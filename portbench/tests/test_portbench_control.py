"""On the card, at each cell's own sizes: the control (the reference in
TF32, the precision below the configuration's float32) and, in the
training cell, the half-batch fault each fail one of the cell's numbers
on three seeds, where the program's own fits pass them all. The same readings as ``tools/control.py``. Without a
card the tests skip, decided in the fixture:

    python -m pytest portbench/tests/test_portbench_control.py -q   # on the card
"""
import pytest

from portbench.harness import spec
from portbench.tools import control

BENCH = spec.with_parked(spec.load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); this machine has none")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_fail_a_number_of_the_cell(card, cell):
    entry = spec.cell(BENCH, cell)
    limits = spec.config(BENCH, entry["config"])["limits"]
    for seed in (101, 2**31 + 5, 987654321):
        r = control.readings(cell, seed, card)
        if "answer_gap_tf32" in r:
            assert r["answer_gap_tf32"] > limits["serve_closed_loop"]["answer_gap"]
            continue
        lim = limits["train_fits"]
        assert all(r[f"{k}_program"] <= v for k, v in lim.items()), r
        for name in ("tf32", "half_batch", "late_count"):
            assert any(r[f"{k}_{name}"] > v for k, v in lim.items()), (name, r)
