"""The port's copies of the host-only modules against the originals.

`lanpaint_tpu_torch/config.py`, `sigmas.py` and `tokenizers.py` are copies
(importing the JAX package's would import jax), and so are the checkpoint
reader's C++ (`native/convert.cpp`), the LoRA merge (`models/lora.py`) and
the web UI (`webui.py`, less the JAX package's `chunk_steps` lines), byte
for byte.  Defaults, validation and the derived
properties must agree, and every scheduler must give the same ladder,
bit for bit.  So must the solvers' host tables in `samplers.py`: the deis
coefficients (`_deis_coeffs`, numpy), heunpp2's full-ladder rows
(`prepare_tables`) and dpm_fast's step grouping, and the Qwen2.5-VL host
helpers: the vision tower's window plan (`models/vision.vision_plan`),
`smart_resize` and the multimodal rope ids (`text.qwen_vl_pos_ids`).
"""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

from lanpaint_tpu import config as jconfig
from lanpaint_tpu import samplers as jsamplers
from lanpaint_tpu import sigmas as jsigmas
from lanpaint_tpu import tokenizers as jtokenizers
from lanpaint_tpu_torch import config as tconfig
from lanpaint_tpu_torch import samplers as tsamplers
from lanpaint_tpu_torch import sigmas as tsigmas
from lanpaint_tpu_torch import tokenizers as ttokenizers

REPO = Path(__file__).resolve().parent.parent


def test_config_defaults_match():
    want = dataclasses.asdict(jconfig.LanPaintConfig())
    got = dataclasses.asdict(tconfig.LanPaintConfig())
    assert got == want
    assert [f.name for f in dataclasses.fields(tconfig.LanPaintConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.LanPaintConfig)]
    assert [k.value for k in tconfig.ModelKind] == [k.value for k in jconfig.ModelKind]


@pytest.mark.parametrize("bad", [dict(n_steps=-1), dict(inner_patience=0),
                                 dict(step_size=0.0), dict(beta=-1.0),
                                 dict(step_size=float("nan"))])
def test_config_validation_matches(bad):
    with pytest.raises(ValueError) as want:
        jconfig.LanPaintConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfig.LanPaintConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(inner_patience=3), dict(inner_min_steps=5),
                                dict(inner_patience=2, inner_min_steps=2),
                                dict(inner_threshold=0.1), dict(inner_threshold=0.0,
                                                                inner_patience=4)])
def test_config_derived_properties_match(kw):
    j, t = jconfig.LanPaintConfig(**kw), tconfig.LanPaintConfig(**kw)
    assert t.patience_eff == j.patience_eff
    assert t.semantic_stop_possible == j.semantic_stop_possible


def test_sigma_tables_match():
    for j, t in ((jsigmas.EpsSigmaTable(), tsigmas.EpsSigmaTable()),
                 (jsigmas.FlowSigmaTable(shift=3.0), tsigmas.FlowSigmaTable(shift=3.0))):
        np.testing.assert_array_equal(np.asarray(t.sigmas), np.asarray(j.sigmas))
        assert t.sigma_min == j.sigma_min and t.sigma_max == j.sigma_max


@pytest.mark.parametrize("scheduler", sorted(jsigmas.SCHEDULERS))
def test_calculate_sigmas_matches(scheduler):
    assert sorted(tsigmas.SCHEDULERS) == sorted(jsigmas.SCHEDULERS)
    for table_cls in (lambda m: m.EpsSigmaTable(), lambda m: m.FlowSigmaTable(shift=1.15)):
        jt, tt = table_cls(jsigmas), table_cls(tsigmas)
        for steps in (1, 4, 20, 33):
            want = jsigmas.calculate_sigmas(jt, scheduler, steps)
            got = tsigmas.calculate_sigmas(tt, scheduler, steps)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f"{scheduler} x {steps}")
            for denoise in (1.0, 0.6):
                np.testing.assert_array_equal(
                    np.asarray(tsigmas.apply_denoise(tt, scheduler, steps, denoise)),
                    np.asarray(jsigmas.apply_denoise(jt, scheduler, steps, denoise)))


@pytest.mark.parametrize("n", [2, 5, 20, 33])
def test_deis_and_heunpp2_tables_match_jax(n):
    sigmas = tsigmas.karras(n, 0.03, 14.6).astype(np.float32)
    np.testing.assert_array_equal(tsamplers._deis_coeffs(sigmas),
                                  jsamplers._deis_coeffs(sigmas))
    for name in ("deis", "heunpp2", "euler"):
        want = jsamplers.prepare_tables(name, sigmas)
        got = tsamplers.prepare_tables(name, sigmas)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_dpm_fast_groups_match_jax():
    for total in range(1, 40):
        assert tsamplers._dpm_fast_orders(total) == jsamplers._dpm_fast_orders(total)


def test_tokenizers_module_is_the_original():
    """The same source, so the same classes, functions and constants."""
    assert inspect.getsource(ttokenizers) == inspect.getsource(jtokenizers)
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("__"))  # noqa: E731
    assert public(ttokenizers) == public(jtokenizers)


@pytest.mark.parametrize("name", ["models/lora.py", "webui.py"])
def test_numpy_only_modules_are_the_originals(name):
    """The LoRA merge (numpy only) and the web UI (one HTML string) are
    copies, byte for byte, with the same public names; the web UI less the
    lines of the JAX package's `chunk_steps` control and request field,
    which the port has not."""
    import importlib

    got = (REPO / "lanpaint_tpu_torch" / name).read_bytes()
    want = (REPO / "lanpaint_tpu" / name).read_bytes()
    if name == "webui.py":
        want = b"".join(line for line in want.splitlines(keepends=True) if b"chunk" not in line)
    assert got == want
    mod = name[:-3].replace("/", ".")
    j = importlib.import_module(f"lanpaint_tpu.{mod}")
    t = importlib.import_module(f"lanpaint_tpu_torch.{mod}")
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("__"))  # noqa: E731
    assert public(t) == public(j)


def test_native_convert_source_is_byte_identical():
    got = (REPO / "lanpaint_tpu_torch" / "native" / "convert.cpp").read_bytes()
    assert got == (REPO / "lanpaint_tpu" / "native" / "convert.cpp").read_bytes()


VISION_GRIDS = [(1, 6, 10), (1, 8, 12), (2, 10, 6), (1, 70, 70), (1, 74, 52)]


@pytest.mark.parametrize("grid", VISION_GRIDS)
def test_vision_plan_matches(grid):
    from lanpaint_tpu.models import vision as jvision
    from lanpaint_tpu_torch.models import vision as tvision

    for jcfg, tcfg in ((jvision.TINY_VL_VISION_CONFIG, tvision.TINY_VL_VISION_CONFIG),
                       (jvision.QWEN25_VL_VISION_CONFIG, tvision.QWEN25_VL_VISION_CONFIG)):
        want, got = jvision.vision_plan(jcfg, grid), tvision.vision_plan(tcfg, grid)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_vision_plan_refuses_what_jax_refuses():
    from lanpaint_tpu.models import vision as jvision
    from lanpaint_tpu_torch.models import vision as tvision

    with pytest.raises(ValueError) as want:
        jvision.vision_plan(jvision.TINY_VL_VISION_CONFIG, (1, 5, 8))
    with pytest.raises(ValueError) as got:
        tvision.vision_plan(tvision.TINY_VL_VISION_CONFIG, (1, 5, 8))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("size", [(1024, 1024), (1050, 980), (30, 44), (3000, 200), (28, 28),
                                  (768, 1360)])
def test_smart_resize_matches(size):
    from lanpaint_tpu.models import vision as jvision
    from lanpaint_tpu_torch.models import vision as tvision

    for factor in (28, 4):
        assert tvision.smart_resize(*size, factor) == jvision.smart_resize(*size, factor)
    with pytest.raises(ValueError) as want:
        jvision.smart_resize(1, 300)
    with pytest.raises(ValueError) as got:
        tvision.smart_resize(1, 300)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_before, grid, n_after", [(3, (1, 4, 6), 4), (0, (1, 70, 70), 0),
                                                    (64, (1, 70, 70), 17), (5, (2, 8, 4), 1)])
def test_qwen_vl_pos_ids_match(n_before, grid, n_after):
    from lanpaint_tpu import text as jtext
    from lanpaint_tpu_torch import text as ttext

    want = jtext.qwen_vl_pos_ids(n_before, grid, n_after)
    got = ttext.qwen_vl_pos_ids(n_before, grid, n_after)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
