"""The control of each cell's comparison, on the card at the cell's own size: the frozen
reference computed in the precision just below the configuration's, put in the program's
place, has to come out as not correct (`program.load`).  Run on a machine with the card:
`python -m pytest -m cuda benchmark/tests/test_bench_control.py`."""

import math

import pytest

from benchmark import run

# a short window: each run goes on after it until the frames it checks have run
CONTROLS = [("fleet_plwg", "tf32", 4.0), ("vehicle_images", "tf32", 4.0),
            ("vehicle_kaist", "f32_state", 4.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control,seconds", CONTROLS, ids=[c[0] for c in CONTROLS])
def test_control_is_not_correct(card, cell, control, seconds):
    rec = run.run_cell(cell, 2**31 + 901, seconds, False, card, control=control)
    checks = rec["checks"]
    assert all(math.isfinite(v) for v, _ in checks.values()), checks
    assert not all(v <= lim for v, lim in checks.values()), checks
