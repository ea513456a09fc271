"""On the card, at each cell's own size: the control fails the check, and
each fault the cell can have, planted in the program's timed path, turns
``correct`` false. Skips without a card (decided inside each test).

    python -m pytest port_bench/tests/test_port_bench_card.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from port_bench import control, faults, run

CELLS = {"train": "train-mip360-3m", "serve": "serve-mip360-3m"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_fails_at_the_cells_size(kind):
    _card()
    spec = run.load_spec(run.ROOT)
    cell, cfg, mix = run.resolve(spec, run.ROOT, CELLS[kind])
    got = control.control_readings(run.Context(
        cell, cfg, mix, 7_000_000_001, torch.device("cuda"), False))
    assert any(got[k] > v for k, v in mix["limits"].items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(CELLS)
                                        for f in faults.FAULTS[k]])
def test_a_fault_fails_at_the_cells_size(kind, fault, capsys):
    _card()
    with faults.plant(fault):
        got = run.main(["--workload", CELLS[kind], "--seed", "7000000003",
                        "--seconds", "20"])
    capsys.readouterr()
    assert got["correct"] is False, got["checks"]
