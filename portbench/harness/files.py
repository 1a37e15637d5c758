"""Finding a cell's files by the names in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH.parent                               # the checkout


def load_module(path: Path, tag: str):
    """Import a file of the benchmark by its path (names hold '-' and '.')."""
    name = "portbench_" + tag.replace("-", "_").replace(".", "_").replace("/", "_")
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def traffic(name: str) -> dict:
    """The cell's traffic: `workloads/<cell>.json`."""
    return json.loads((BENCH / "workloads" / f"{name}.json").read_text())


def config_sizes(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def config_module(name: str):
    return load_module(BENCH / "configs" / f"{name}.py", f"config_{name}")


def entry_module(name: str):
    return load_module(BENCH / "entries" / f"{name}.py", f"entry_{name}")


def metric_module(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", f"metric_{name}")


def config_of(cls, sizes: dict, **changes):
    """The program's config dataclass `cls` from a configuration file's
    sizes (lists as tuples; keys the class lacks ignored), with `changes`."""
    fields = cls.__dataclass_fields__
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()
          if k in fields and k not in changes}
    return cls(**kw, **changes)


def metrics_of(cell_name: str, bench: dict) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    def mine(m):
        return "workloads" not in m or cell_name in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
