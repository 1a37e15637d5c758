"""The port's ControlNet (lanpaint_tpu_torch.models.controlnet), the UNet's
`control=` injection, the ControlNet checkpoint entries and
`zoo.build_controlled_unet` against the JAX package, on the tiny UNet
config in fp32.

The JAX package initializes every zero conv and `middle_block_out` to
zero, so a ControlNet at init adds exactly nothing, and a port that routed
a residual to the wrong skip would still agree with it.  So every
comparison here first draws random values for every leaf of the flax
trees, the zero convs included (`test_torch_unet._random_tree`), and the
UNet tests feed control dicts whose residuals are non-zero and differ from
each other; `test_a_misrouted_residual_is_caught` shows that swapping two
residuals of the same shape moves the output far beyond the tolerance.

Tolerances: 1e-4 (relative and absolute) for the forwards, as
tests/test_torch_unet.py's fp32 check; the sampler run, 1e-4 relative to
the largest value of each compared tensor (tests/test_torch_api.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lanpaint_tpu as J
from lanpaint_tpu.models import controlnet as jcn
from lanpaint_tpu.models import load as JL
from lanpaint_tpu.models import unet as junet
from lanpaint_tpu.models import zoo as jzoo
from lanpaint_tpu_torch import api as tapi
from lanpaint_tpu_torch.models import controlnet as tcn
from lanpaint_tpu_torch.models import load as TL
from lanpaint_tpu_torch.models import unet as tunet
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.models.bridge import (controlnet_params_from_flax, pair_params_from_flax,
                                              unet_params_from_flax)
from test_torch_api import _close, shared_normals  # noqa: F401  (a fixture)
from test_torch_unet import _configs, _random_tree

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (1, 4, 16, 16)
# the tiny UNet's skips by production index: (channels, side)
SKIPS = [(32, 16), (32, 16), (32, 8), (64, 8)]
MIDDLE = (64, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are tiny and pytest-xdist workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """The JAX pair's {"unet", "cn"} trees, every leaf random (zero convs too)."""
    jcfg, _ = _configs("fp32")
    _, params = jzoo.build_controlled_unet(jcfg)
    return {"unet": _random_tree(params["unet"], seed=7), "cn": _random_tree(params["cn"], seed=8)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    return dict(x=rng.standard_normal(SHAPE).astype(np.float32),
                hint=rng.uniform(-1, 1, (1, 3, 128, 128)).astype(np.float32),
                t=np.array([412.5], np.float32),
                ctx=rng.standard_normal((1, 8, 32)).astype(np.float32))


def _port_modules(trees):
    _, tcfg = _configs("fp32")
    unet = tunet.UNetModel(tcfg).eval()
    unet.load_state_dict(unet_params_from_flax(trees["unet"]))
    cn = tcn.ControlNet(tcfg).eval()
    cn.load_state_dict(controlnet_params_from_flax(trees["cn"]))
    return unet, cn


def _nhwc(a):
    return None if a is None else jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return None if a is None else torch.from_numpy(a)


def test_controlnet_residuals_match_jax(trees, inputs):
    jcfg, _ = _configs("fp32")
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jcn.ControlNet(jcfg).apply)(
            trees["cn"], jnp.asarray(inputs["x"]), jnp.asarray(inputs["hint"]),
            jnp.asarray(inputs["t"]), jnp.asarray(inputs["ctx"]), None)
    _, cn = _port_modules(trees)
    with torch.no_grad():
        got = cn(*(torch.from_numpy(inputs[k]) for k in ("x", "hint", "t", "ctx")))
    assert sorted(got) == ["middle", "output"]
    assert len(got["output"]) == len(want["output"]) == len(SKIPS) == cn.n_zero
    for g, w, (c, side) in zip(got["output"], want["output"], SKIPS):
        assert tuple(g.shape) == (1, c, side, side)
        np.testing.assert_allclose(g.numpy(), np.transpose(np.asarray(w), (0, 3, 1, 2)), **TOL)
        assert float(g.abs().mean()) > 0.1  # the random zero convs act
    assert tuple(got["middle"].shape) == (1, *MIDDLE[:1], MIDDLE[1], MIDDLE[1])
    np.testing.assert_allclose(got["middle"].numpy(),
                               np.transpose(np.asarray(want["middle"]), (0, 3, 1, 2)), **TOL)


def _residuals(seed):
    """Distinct non-zero residuals in NCHW, one per skip, and a middle one."""
    rng = np.random.default_rng(seed)
    skips = [(0.5 + 0.1 * j) * rng.standard_normal((1, c, s, s)).astype(np.float32)
             for j, (c, s) in enumerate(SKIPS)]
    mid = rng.standard_normal((1, MIDDLE[0], MIDDLE[1], MIDDLE[1])).astype(np.float32)
    return skips, mid


def _controls(case):
    """The case's control dict in NCHW numpy (None entries kept)."""
    skips_in, mid = _residuals(1)
    skips_out, _ = _residuals(2)
    if case == "input":
        return {"input": skips_in}
    if case == "output":
        return {"output": skips_out}
    if case == "middle":
        return {"middle": mid}
    if case == "all":
        return {"input": skips_in, "output": skips_out, "middle": mid}
    # None entries, and lists shorter than the 4 skips
    return {"input": [None, skips_in[1]], "output": [skips_out[0], None, skips_out[2]],
            "middle": None}


def _jax_control(control):
    """`control` in JAX's full structure (NHWC), zeros where the port's is
    None or short: one trace of the jitted forward serves every case, and
    adding zeros is what a None entry means."""
    control = control or {}

    def entries(name):
        got = list(control.get(name) or [])
        got += [None] * (len(SKIPS) - len(got))
        return [jnp.zeros((1, s, s, c)) if a is None else _nhwc(a)
                for a, (c, s) in zip(got, SKIPS)]

    mid = control.get("middle")
    return {"input": entries("input"), "output": entries("output"),
            "middle": (jnp.zeros((1, MIDDLE[1], MIDDLE[1], MIDDLE[0])) if mid is None
                       else _nhwc(mid))}


@pytest.fixture(scope="module")
def unet_pair(trees, inputs):
    """(port output, JAX output) of the UNet forward under a control dict."""
    jcfg, _ = _configs("fp32")
    japply = jax.jit(junet.UNetModel(jcfg).apply)
    unet, _ = _port_modules(trees)

    def run(control):
        with jax.default_matmul_precision("highest"):
            want = japply(trees["unet"], jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                          jnp.asarray(inputs["ctx"]), None, _jax_control(control))
        port_ctl = None if control is None else {
            k: ([_nchw(c) for c in v] if isinstance(v, list) else _nchw(v))
            for k, v in control.items()}
        with torch.no_grad():
            got = unet(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
                       torch.from_numpy(inputs["ctx"]), None, port_ctl)
        return got.numpy(), np.asarray(want)

    return run


@pytest.mark.parametrize("case", ["input", "output", "middle", "all", "sparse"])
def test_unet_control_matches_jax(unet_pair, case):
    got, want = unet_pair(_controls(case))
    np.testing.assert_allclose(got, want, **TOL)
    base, base_want = unet_pair(None)
    np.testing.assert_allclose(base, base_want, **TOL)
    assert np.abs(got - base).max() > 100 * TOL["atol"]  # the control acted


def test_a_misrouted_residual_is_caught(unet_pair):
    """Skips 0 and 1 have the same shape: the port fed the two "output"
    residuals swapped lies far outside the tolerance of JAX's forward, so
    the comparisons above would catch a residual wired to the wrong skip."""
    ctl = _controls("output")
    _, want = unet_pair(ctl)
    swapped = dict(ctl, output=[ctl["output"][1], ctl["output"][0], *ctl["output"][2:]])
    got, _ = unet_pair(swapped)
    assert np.abs(got - want).max() > 100 * TOL["atol"]


def test_residuals_take_the_activation_dtype(trees, inputs):
    """bf16 residuals into an fp32 UNet are cast before the add."""
    ctl = _controls("all")
    as_bf16 = {k: ([torch.from_numpy(c).to(torch.bfloat16) for c in v] if isinstance(v, list)
                   else torch.from_numpy(v).to(torch.bfloat16)) for k, v in ctl.items()}
    unet, _ = _port_modules(trees)
    with torch.no_grad():
        got = unet(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
                   torch.from_numpy(inputs["ctx"]), None, as_bf16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())


def test_zero_init_is_a_bit_exact_noop(inputs):
    """Without state dicts the zero convs and middle_block_out start at zero,
    as the JAX package's: every residual is exactly zero and the pair's
    forward with a hint equals its forward without one, bit for bit."""
    _, tcfg = _configs("fp32")
    den, (unet, cn) = tzoo.build_controlled_unet(tcfg, device="cpu", seed=3)
    for conv in cn.zero_convs():
        assert not bool(conv.weight.any()) and not bool(conv.bias.any())
    assert any(bool(p.any()) for n, p in cn.named_parameters() if "zero_conv" not in n)
    x, hint, ctx = (torch.from_numpy(inputs[k]) for k in ("x", "hint", "ctx"))
    with torch.no_grad():
        res = cn(x, hint, torch.from_numpy(inputs["t"]), ctx)
    assert all(not bool(r.any()) for r in res["output"] + [res["middle"]])
    sigma = torch.tensor([3.7])
    plain = den.apply(x, sigma, {"context": ctx})
    assert torch.equal(den.apply(x, sigma, {"context": ctx, "hint": hint}), plain)
    assert sorted(dict(den.module.named_children())) == ["cn", "unet"]


def test_export_keys_and_round_trip_match_jax(trees):
    """The port's exporter gives the JAX exporter's keys and tensors; its
    importer takes JAX's export to the bridge of JAX's tree, and its own
    export back to the same state."""
    jcfg, tcfg = _configs("fp32")
    want = JL.export_controlnet(trees["cn"], jcfg)
    _, cn = _port_modules(trees)
    state = cn.state_dict()
    got = TL.export_controlnet(state, tcfg)
    assert sorted(got) == sorted(want)
    for key in ("control_model.input_hint_block.14.weight", "control_model.zero_convs.3.0.weight",
                "control_model.middle_block_out.0.bias",
                "control_model.input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"):
        assert key in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    imported = TL.import_controlnet({k: np.asarray(v) for k, v in want.items()}, tcfg)
    assert sorted(imported) == sorted(state)
    for k, v in state.items():
        assert torch.equal(imported[k], v), k
    again = TL.import_controlnet(got, tcfg)
    assert all(torch.equal(again[k], v) for k, v in state.items())
    n_zero = sum(1 for k in got if ".zero_convs." in k and k.endswith(".weight"))
    assert n_zero == len(SKIPS)


def test_scale_control_matches_jax():
    rng = np.random.default_rng(5)
    a, b, m = (rng.standard_normal((1, 2, 3, 3)).astype(np.float32) for _ in range(3))
    want = jcn.scale_control({"output": [jnp.asarray(a), None, jnp.asarray(b)],
                              "middle": jnp.asarray(m), "input": None}, 0.35)
    got = tcn.scale_control({"output": [torch.from_numpy(a), None, torch.from_numpy(b)],
                             "middle": torch.from_numpy(m), "input": None}, 0.35)
    assert got["input"] is None and got["output"][1] is None
    for g, w in ((got["output"][0], want["output"][0]), (got["output"][2], want["output"][2]),
                 (got["middle"], want["middle"])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _samplers(trees, strength=0.7):
    jcfg, tcfg = _configs("fp32")
    jden, _ = jzoo.build_controlled_unet(jcfg, trees["unet"], trees["cn"], strength=strength)
    tden, _ = tzoo.build_controlled_unet(tcfg, device="cpu", strength=strength)
    tden.module.load_state_dict(pair_params_from_flax(trees))
    return jden, tden


def _hinted_conds(inputs, lib, hint_in=("pos", "neg")):
    rng = np.random.default_rng(41)
    unctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    to = jnp.asarray if lib is jnp else torch.from_numpy
    pos, neg = {"context": to(inputs["ctx"])}, {"context": to(unctx)}
    for name, cond in (("pos", pos), ("neg", neg)):
        if name in hint_in:
            cond["hint"] = to(inputs["hint"])
    return pos, neg


def test_controlled_ksampler_matches_jax(trees, inputs, shared_normals):  # noqa: F811
    """The pair through `api.ksampler` (karras 3 steps, 2 think steps,
    batched CFG 5: the hint concatenated with the cond), both packages
    drawing the same normals (test_torch_api.shared_normals)."""
    jden, tden = _samplers(trees)
    mask = np.zeros(SHAPE[2:], np.float32)
    mask[4:12, 3:11] = 1.0
    kw = dict(seed=2, steps=3, cfg=5.0, scheduler="karras", num_steps=2)
    with jax.default_matmul_precision("highest"):
        pos, neg = _hinted_conds(inputs, jnp)
        want = J.ksampler(jden, positive=pos, negative=neg, latent=jnp.asarray(inputs["x"]),
                          mask=jnp.asarray(mask), **kw)
    pos, neg = _hinted_conds(inputs, torch)
    got = tapi.ksampler(tden, positive=pos, negative=neg, latent=torch.from_numpy(inputs["x"]),
                        mask=torch.from_numpy(mask), **kw)
    _close(got, want)
    # the hint moved the run: the same sampler without one differs
    plain = tapi.ksampler(tden, positive={"context": pos["context"]},
                          negative={"context": neg["context"]},
                          latent=torch.from_numpy(inputs["x"]), mask=torch.from_numpy(mask), **kw)
    assert float((plain - got).abs().max()) > 1e-2


def test_hint_in_one_cond_raises_under_batched_cfg(trees, inputs):
    """cond and uncond of different keys cannot be concatenated for the
    batched CFG pass: ValueError in both packages (sequential CFG runs)."""
    jden, tden = _samplers(trees)
    kw = dict(seed=0, steps=2, cfg=5.0, num_steps=1)
    with pytest.raises(ValueError):
        pos, neg = _hinted_conds(inputs, jnp, hint_in=("pos",))
        J.ksampler(jden, positive=pos, negative=neg, latent=jnp.asarray(inputs["x"]), **kw)
    pos, neg = _hinted_conds(inputs, torch, hint_in=("pos",))
    with pytest.raises(ValueError, match="differ in their keys"):
        tapi.ksampler(tden, positive=pos, negative=neg, latent=torch.from_numpy(inputs["x"]),
                      **kw)
    out = tapi.ksampler(tden, positive=pos, negative=neg, latent=torch.from_numpy(inputs["x"]),
                        sequential_cfg=True, **kw)
    assert bool(torch.isfinite(out).all())
