"""On the card, at each cell's own sizes: the control comes out not
correct, and so does a run with the timed path broken in each way the
cell can be broken (test_portbench_faults.py's faults).  Skips without a
CUDA card."""

import math
import time

import pytest
import torch

from portbench.harness import files, runner
from portbench.tests import test_portbench_faults as faults

CELLS = [w["name"] for w in files.benchmark()["workloads"]]
SEED = 3_100_000_007


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, **kw):
    return runner.run_cell(cell, SEED, 0.0, False, t0=time.perf_counter(), **kw)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference with float8 operands in the program's place, through
    the whole run (control.py reads it over more seeds)."""
    _card()
    from portbench import control

    with control.control_in_place(files.config_module(files.traffic(cell)["config"])):
        out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [f for f in faults.FAULTS if f != "half_batch"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    _card()
    faults.FAULTS[fault](monkeypatch, next(k for k, v in faults.tiny.CELLS.items() if v == cell))
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(cell, monkeypatch):
    """The uncond half of the CFG batch left out, at the cell's own
    conditioning (no scaling)."""
    _card()
    if math.isclose(files.traffic(cell)["cfg"], 1.0):
        pytest.skip("cfg 1: the batch holds no uncond half to leave out")
    from lanpaint_tpu_torch import api

    real = api.make_cfg_double_denoiser
    monkeypatch.setattr(api, "make_cfg_double_denoiser",
                        lambda fn, cond, uncond, *a, **k: real(fn, cond, None, *a, **k))
    out = _run(cell)
    assert not out["correct"], out["checks"]
