"""A run driven end to end at tiny sizes on the CPU (the look for a card
skipped), first sound, then with the timed path broken underneath in each
way a cell can be broken: `correct` has to come out false.  One card, so
no exchange between cards to leave out."""

import math

import pytest
import torch

from portbench.harness import files, runner
from portbench.tests import tiny

SEED = 2**31 + 77


def _run(name, **kw):
    cell = tiny.CELLS[name]
    return runner.run_cell(cell, SEED, 0.0, False, t0=0.0, device="cpu",
                           sizes=tiny.SIZES[name], traffic=tiny.traffic(cell), **kw)


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0


def _state_unchanged(monkeypatch, name):
    from lanpaint_tpu_torch import samplers

    def euler(model, c, s, sn, i, gen):
        den, _ = model(c.x, s)
        return c, den

    monkeypatch.setitem(samplers._SOLVERS, "euler", euler)


def _half_batch(monkeypatch, name):
    """The uncond half of the CFG batch left out: the cond half stands for
    both.  At tiny widths random weights barely read the conditioning (the
    cond and uncond outputs nearly coincide), so here it is drawn 20 times
    larger, for the sound run as much as for the fault."""
    from lanpaint_tpu_torch import api

    config = files.config_module(tiny.CELLS[name].split(".")[0])
    draw = config.conditioning
    monkeypatch.setattr(config, "conditioning",
                        lambda *a: {k: 20 * v for k, v in draw(*a).items()})
    real = api.make_cfg_double_denoiser
    monkeypatch.setattr(api, "make_cfg_double_denoiser",
                        lambda fn, cond, uncond, *a, **k: real(fn, cond, None, *a, **k))


def _answer_altered(monkeypatch, name):
    """The backbone's x0 off by 5% where it is produced."""
    config = files.config_module(tiny.CELLS[name].split(".")[0])
    real = config.build_program

    def build(*a, **k):
        den, module = real(*a, **k)
        apply = den.apply
        den.apply = lambda x, t, c: apply(x, t, c) * 1.05
        return den, module

    monkeypatch.setattr(config, "build_program", build)


def _known_region_moved(monkeypatch, name):
    """The blend leaves the known region 1e-3 off the latent."""
    from lanpaint_tpu_torch import api

    real = api.lanpaint_update

    def update(*a, **k):
        out, x, aux = real(*a, **k)
        return out + 1e-3 * k["latent_mask"], x, aux

    monkeypatch.setattr(api, "lanpaint_update", update)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "known_region_moved": _known_region_moved}


@pytest.mark.parametrize("name", list(tiny.SIZES))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    traffic = files.traffic(tiny.CELLS[name])
    if fault == "half_batch" and math.isclose(traffic["cfg"], 1.0):
        pytest.skip("cfg 1: the batch holds no uncond half to leave out")
    FAULTS[fault](monkeypatch, name)
    out = _run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_control_reads_apart(name):
    """The reference with float8 operands in the program's place, driven
    through the same run and comparison, reads at least three times the
    sound program's `step_err` at tiny sizes (at the cell's own sizes, not
    correct: test_portbench_card.py)."""
    from portbench import control

    sound = _run(name)["checks"]["step_err"]["value"]
    with control.control_in_place(files.config_module(tiny.CELLS[name].split(".")[0])):
        out = _run(name)
    assert out["checks"]["step_err"]["value"] > 3 * sound, (sound, out["checks"])


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_jobs_that_raise_fail_alone(name, monkeypatch):
    """A window whose every job raises still ends in a result line, with
    each job counted failed and `correct` false (the warm-up job, in
    set-up, runs)."""
    from lanpaint_tpu_torch import api

    real, warmup = api.ksampler, tiny.traffic(tiny.CELLS[name])["warmup_steps"]

    def broken(*a, **k):
        if k["steps"] != warmup:
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(api, "ksampler", broken)
    out = _run(name)
    assert not out["correct"] and out["failed"] == out["attempted"] == 1


def test_card_refused_without_one(monkeypatch, capsys):
    """run.py exits non-zero and prints no result without a CUDA card."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location("portbench_run", files.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.main(["--workload", "sdxl-1024.single", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_reference_in_place_reads_nought(name):
    """The float32 reference in the program's place, through the port's
    sampler: every checked step, the first with it, reads exactly 0, so
    what a sound run reads is the bfloat16 model's rounding alone."""
    from portbench import control

    with control.control_in_place(files.config_module(tiny.CELLS[name].split(".")[0]), "fp32"):
        out = _run(name)
    per_step = out["_check"]["per_step"]
    assert 0 in per_step and all(v["step_err"] == 0.0 for v in per_step.values()), per_step
    assert out["correct"]
