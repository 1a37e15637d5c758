"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device (and with --trace 1 breakdown), and
last `checks`, each compared number beside its limit; the same numbers
are the last lines of standard error.  Without a CUDA card, with fewer
cards than the cell needs, or if JAX or the JAX package was loaded, it
exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # every compiler cache at a fixed place inside the checkout (the port's
    # own nvcc builds go to lanpaint_tpu_torch/_build/, also inside it)
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    import torch

    from portbench.harness import files, nojax, runner

    cell = files.cell(args.workload, files.benchmark())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    check = out.pop("_check")
    found = nojax.loaded()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    print("request seconds " + " ".join(f"{t:.4f}" for t in check["latencies"]),
          file=sys.stderr)
    print(f"job {check['job']}, steps {check['steps']}: " + "; ".join(
        f"step {i} step_err {v['step_err']:.6g} x0_gap {v['x0_gap']:.6g}"
        for i, v in check["per_step"].items()), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
