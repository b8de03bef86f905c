"""The control on the card: the reference in float8 put in the program's
place has to come out not correct, while the program, on the same run,
comes out correct.  Each cell at its own size and load, with an 8-second
window (~1.5 min a cell); the readings the limits were set from are in
PERF.md.

    python -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""
from __future__ import annotations

import gc
import time

import pytest

from portbench.harness import bench
from portbench.harness import spec as S

CELLS = S.cell_names(S.load_spec())


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only there")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    c = S.resolve_cell(S.load_spec(), cell)
    out = bench.run_cell(c, 7_000_000_001, 8.0, False,
                         t_start=time.perf_counter(), control=True)
    correct, checks, control = out["correct"], out["checks"], out["control"]
    del out
    gc.collect()      # the engine and its wrappers are reference cycles
    card.cuda.empty_cache()
    assert correct, checks
    assert any(v["value"] > v["limit"] for v in control.values()), control
