"""The port's example scripts (lanpaint_tpu_torch/examples/: common.py and
17 scripts, the 18 files of examples/), each the twin of one of examples/:
every one builds its argparse surface (`--help`)
and runs its smoke mode on the CPU (`--smoke --device cpu`, the fewest
steps its flags allow) to exit 0 with a finite output.

Each runs in this process through `runpy` with `sys.argv` set, as
`python -m lanpaint_tpu_torch.examples.<name>` would run it (no
subprocess re-imports torch 18 times).  `wan22_seq_parallel` runs as a
world of one (gloo, its own process group, destroyed at its end);
`serving_http` with `--selftest` (two in-process requests), since its smoke
mode alone serves HTTP until interrupted.
"""

import contextlib
import io
import runpy
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

EXAMPLES = sorted(p.stem for p in (Path(__file__).resolve().parent.parent / "lanpaint_tpu_torch"
                                   / "examples").glob("*.py")
                  if p.stem not in ("__init__", "common"))
FEWEST = ["--steps", "2", "--think-steps", "1"]
SMOKE = {name: ["--smoke", "--device", "cpu"] + FEWEST for name in EXAMPLES}
SMOKE["serving_http"] = ["--smoke", "--device", "cpu", "--selftest"]
SMOKE["wan22_video_inpaint --pixel"] = SMOKE["wan22_video_inpaint"] + ["--pixel"]


def run_example(name: str, argv) -> tuple:
    """(exit code, stdout) of `python -m lanpaint_tpu_torch.examples.<name>
    <argv>`, run in this process."""
    saved, threads = sys.argv, torch.get_num_threads()
    sys.argv = [name] + list(argv)
    # tiny models: one thread, so that beside the suite's other workers no
    # thread pool waits on cores it cannot get
    torch.set_num_threads(1)
    out = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(f"lanpaint_tpu_torch.examples.{name}", run_name="__main__",
                             alter_sys=False)
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = saved
        torch.set_num_threads(threads)
    return code, out.getvalue()


def test_every_jax_example_has_a_twin():
    jax_examples = {p.stem for p in (Path(__file__).resolve().parent.parent / "examples")
                    .glob("*.py") if p.stem != "common"}
    assert set(EXAMPLES) == jax_examples and len(EXAMPLES) == 17


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_help_runs(name):
    code, out = run_example(name, ["--help"])
    assert code == 0 and "usage:" in out.lower()
    assert "--device" in out and "--smoke" in out


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_example_smoke_runs_on_the_cpu(case):
    name, *extra = case.split()
    code, out = run_example(name, SMOKE[case])
    assert code == 0, out
    assert "finite=True" in out, out
    assert not dist.is_initialized()  # the world-of-one example destroys its group
