"""BENCHMARK.json's shape and limits, and every file a cell,
configuration, entry or metric needs found by its name."""

import json
import re

import pytest

from portbench.harness import files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = files.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((files.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    t = files.traffic(w["name"])
    assert t["config"] == w["config"] and w["chips"] == 1
    sizes = files.config_sizes(w["config"])
    assert sizes["name"] == w["config"]
    config = files.config_module(w["config"])
    for fn in ("build_program", "build_reference", "sigma_table", "conditioning", "flops",
               "attention_calls", "cfg_big"):
        assert callable(getattr(config, fn))
    entry = files.entry_module(t["entry"])
    assert callable(entry.setup) and callable(entry.run_window) and callable(entry.check)
    e2e, per_layer = files.metrics_of(w["name"], BENCH)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and per_layer
    assert set(t["limits"]) == {"step_err", "known_err"}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    assert callable(files.metric_module(m["name"]).read)
    assert m["better"] in ("lower", "higher")
    if "layer" in m:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    else:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = files.ROOT / c["file"]
    assert path.is_file() and c["file"].startswith("portbench/")
    assert json.loads(path.read_text())["source"] == c["source"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_per_layer_metrics_move_what_the_cell_reports(w):
    e2e, per_layer = files.metrics_of(w["name"], BENCH)
    assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}
