"""The readers of the program's spans (`engine.think_ms`, `model.issue_ms`
and their `.host` names) on hand-built job records, on none, on a program
without the recorder, and on a tiny job's own records."""

import sys
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import files

READERS = ("engine.think_ms", "model.issue_ms", "engine.think_ms.host", "model.issue_ms.host")


def _span(name, parent, host_ms, device_ms):
    return {"name": name, "parent": parent, "start_ms": 0.0, "host_ms": host_ms,
            "device_ms": device_ms, "attrs": {}}


def _job(think, final_forward=(9.0, 50.0)):
    """One job: a step holding a think iteration per (iteration host / device
    ms, its forward's host / device ms), then the final forward."""
    spans = [_span("sampler.job", None, 1e3, 1e3), _span("sampler.step", 0, 900.0, None)]
    for (it_host, it_dev), (f_host, f_dev) in think:
        spans.append(_span("engine.think_iter", 1, it_host, it_dev))
        spans.append(_span("model.forward", len(spans) - 1, f_host, f_dev))
    spans.append(_span("model.forward", 1, *final_forward))
    return {"host_ms": 1e3, "device_ms": 1e3, "attrs": {}, "spans": spans}


def read(name, jobs, monkeypatch, n=None):
    from lanpaint_tpu_torch import telemetry

    monkeypatch.setattr(telemetry, "jobs", lambda last=None: jobs[max(0, len(jobs) - last):])
    return files.metric_module(name).read(SimpleNamespace(jobs=len(jobs) if n is None else n))


def test_readers_on_hand_built_jobs(monkeypatch):
    warmup = _job([((1.0, 900.0), (1.0, 100.0))], final_forward=(1.0, 1.0))
    jobs = [warmup,
            _job([((5.0, 52.0), (4.0, 50.0)), ((6.0, 53.5), (5.0, 50.0))]),
            _job([((5.0, 51.0), (7.0, 50.0))], final_forward=(8.0, 60.0))]
    # think: 2.0, 3.5, 1.0 over the window's two jobs; the warm-up's 800 is left out
    assert read("engine.think_ms", jobs, monkeypatch, n=2) == 2.0
    assert read("engine.think_ms.host", jobs, monkeypatch, n=2) == 2.0
    # forwards' host ms: 4, 5, 9 and 7, 8: the median 7
    assert read("model.issue_ms", jobs, monkeypatch, n=2) == 7.0
    assert read("model.issue_ms.host", jobs, monkeypatch, n=2) == 7.0
    # an iteration whose forward is not resolved is left out
    jobs[2]["spans"][3]["device_ms"] = None
    assert read("engine.think_ms", jobs, monkeypatch, n=2) == 2.75


@pytest.mark.parametrize("name", READERS)
def test_readers_on_no_records(monkeypatch, name):
    assert read(name, [], monkeypatch) is None
    assert read(name, [_job([((1.0, 2.0), (1.0, 1.0))])], monkeypatch, n=0) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_recorder(monkeypatch, name):
    """The parent of the recorder has no `telemetry`: nothing is read."""
    monkeypatch.setitem(sys.modules, "lanpaint_tpu_torch.telemetry", None)
    import lanpaint_tpu_torch

    monkeypatch.delattr(lanpaint_tpu_torch, "telemetry", raising=False)
    assert files.metric_module(name).read(SimpleNamespace(jobs=3)) is None


def test_readers_on_a_tiny_jobs_own_spans():
    """On the CPU the spans have host times only: issue time reads, think
    time (a device time) does not."""
    from lanpaint_tpu_torch import api, telemetry
    from lanpaint_tpu_torch.config import ModelKind
    from lanpaint_tpu_torch.models.base import Denoiser
    from lanpaint_tpu_torch.sigmas import EpsSigmaTable

    telemetry.reset()
    toy = Denoiser(apply=lambda x, t, cond: torch.tanh(x) * cond, kind=ModelKind.EPS,
                   sigma_table=EpsSigmaTable())
    mask = torch.zeros((8, 8))
    mask[:4] = 1.0
    for seed in (1, 2):
        api.ksampler(toy, seed=seed, steps=3, cfg=1.0, positive=torch.ones(1),
                     latent=torch.ones((1, 4, 8, 8)), mask=mask, num_steps=2)
    run = SimpleNamespace(jobs=1)
    assert files.metric_module("model.issue_ms").read(run) > 0
    assert files.metric_module("engine.think_ms").read(run) is None
    telemetry.reset()
