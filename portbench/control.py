"""Read a cell's compared numbers over many seeds, for the program and for
the control: the plain reference computed with float8 e4m3 operands
(per-tensor scale), the step below the bfloat16 the configurations serve
in, put in the program's place.  The limits in `workloads/<cell>.json` are
set from these readings; the benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --control 4,5,6

Each seed is one whole run of the cell through `runner.run_cell` with a
window of one job: set-up, the job through the cell's entry, and the
comparison that decides `correct`.  Under `--control` the configuration's
`build_program` returns the port's Denoiser with the reference in its
model's place (`reference_in_place`), so the control's job runs through
the same sampler, window and comparison.  One line of JSON a run, then the
largest program reading and the smallest control reading of each number.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def reference_in_place(config, mode: str = "fp8"):
    """A `build_program` for `config` that builds the port's Denoiser (its
    kind, schedule and flags), frees the port's weights and puts the plain
    reference, computed in `mode`, in its model's place."""
    import torch

    from portbench.reference import nn as rnn

    real = config.build_program

    def build(sizes: dict, state: dict, device):
        den, module = real(sizes, state, device)
        module.to("meta")
        ref_x0, ref_module = config.build_reference(sizes)
        ref_module.load_state_dict(state, assign=True)
        ref_module.requires_grad_(False)

        def apply(x, t, cond):
            with torch.no_grad(), rnn.precision(mode):
                return ref_x0(x, t, cond).to(x.dtype)

        def precompute(cond):
            with torch.no_grad(), rnn.precision(mode):
                return ref_x0.prepare(cond)

        den.apply, den.module = apply, ref_module
        den.precompute = precompute if hasattr(ref_x0, "prepare") else None
        return den, ref_module

    return build


@contextlib.contextmanager
def control_in_place(config, mode: str = "fp8"):
    """`config.build_program` swapped for `reference_in_place` inside."""
    real = config.build_program
    config.build_program = reference_in_place(config, mode)
    try:
        yield
    finally:
        config.build_program = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated seeds of the program")
    p.add_argument("--control", default="", help="comma-separated seeds of the control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import torch

    from portbench.harness import files, runner

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    config = files.config_module(files.traffic(args.workload)["config"])
    seen = {"program": {}, "control": {}}
    for side, seeds in (("program", args.seeds), ("control", args.control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            with control_in_place(config) if side == "control" else contextlib.nullcontext():
                out = runner.run_cell(args.workload, seed, 0.0, False, t0=t0)
            check = out.pop("_check")
            for k, v in check["numbers"].items():
                seen[side].setdefault(k, []).append(v)
            print(json.dumps({"side": side, "seed": seed, "correct": out["correct"],
                              "job": check["job"], "steps": check["steps"],
                              "numbers": check["numbers"], "per_step": check["per_step"],
                              "seconds": time.perf_counter() - t0,
                              "memory_peak_bytes": torch.cuda.max_memory_allocated()}),
                  flush=True)
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: max(v) for k, v in seen["program"].items()},
                      "control_min": {k: min(v) for k, v in seen["control"].items()},
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
