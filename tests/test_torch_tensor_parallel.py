"""Tensor, expert and layer parallelism of the port's UNet, MMDiT, SD3,
HiDream and Wan families (`lanpaint_tpu_torch.parallel`'s rules, the
models' sharded forwards, the zoo builders' `mesh=`) against the JAX
package's GSPMD forwards on the CPU.

The port's side runs as one spawned four-rank `gloo` world
(tests/test_torch_parallel.py's `run_ranks`: a `file://` store under
tmp_path, a timeout on every group, a hard join limit that kills the
ranks).  It covers the tiny UNet at tensor 4 (its 2-head level-0
transformers stay whole under the head rule, its 4-head level splits) and
at data 2 x tensor 2, the tiny Flux DiT and the tiny SD3 (its dual-attention
layer 0 and `joint_last`) at tensor 4, the tiny HiDream at expert 2 x
tensor 2, and the tiny Wan at data 2 x tensor 2 with its blocks
depth-sharded over "data" (`layer_shard_rules`).  JAX's side is
`shard_params_tp(...)` + `jax.jit` of the Denoiser's `raw_apply` under the
mesh, on tests/conftest.py's 8 virtual CPU devices, at "highest" matmul
precision.  All configs are fp32, the weights random (kernels N(0, 0.25 /
fan_in): every block moves the output, which stays within the tolerances
below of JAX's unsharded forward (at N(0, 1 / fan_in) SD3 and HiDream do
not, sharded or not); biases N(0, 0.1^2) and norm scales 1 + N(0, 0.1^2),
so a rank's slice of a replicated bias or scale is exercised) carried
across by models/bridge.py, the inputs from numpy.

Tolerances (tests/test_parallel.py's): rtol 1e-5 / atol 1e-6 for SD3 and
the Flux DiT, 1e-5 / 1e-5 for HiDream, 2e-4 / 2e-5 for the UNet and Wan.

Outside the spawn: the tensors each family's rules cut, on which dim and
over which axis, equal JAX's (mapped through the bridge's key map);
`tp_plan_bytes` equals JAX's for the full-size SDXL, Flux-dev, SD3.5-Large
and HiDream-I1 configs wherever the head rule does not bite, and the bytes
of a rank's meta-device module where it does (SDXL at tensor 4 and 8,
SD3.5-Large at 4 and 8, HiDream-I1 at 8); the layer-sharded Wan plan equals
JAX's; and `dit_tp_rules` on Z-Image raises ValueError where JAX's raise
IndexError.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lanpaint_tpu_torch.models import dit as tdit
from lanpaint_tpu_torch.models import hidream as thd
from lanpaint_tpu_torch.models import sd3 as tsd3
from lanpaint_tpu_torch.models import unet as tunet
from lanpaint_tpu_torch.models import wan as twan
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.parallel import MeshSpec, make_mesh
from lanpaint_tpu_torch.parallel import mesh as tmesh

TOL = {"unet_t4": (2e-4, 2e-5), "unet_d2t2": (2e-4, 2e-5), "dit_t4": (1e-5, 1e-6),
       "sd3_t4": (1e-5, 1e-6), "hidream_e2t2": (1e-5, 1e-5), "wan_d2t2_layers": (2e-4, 2e-5)}
# the full-size configs and the (tensor size) where the head rule bites: a
# block whose head count the axis does not divide stays whole
BITES = {("sdxl", 4), ("sdxl", 8), ("sd35", 4), ("sd35", 8), ("hidream", 8)}


# --------------------------------------------------------------------------
# what the ranks run (torch and the port only)


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


def _tp_ranks(rank, data):
    """Every family's sharded forward, in one spawn."""
    t = {k: {n: torch.as_tensor(a) for n, a in v.items()} if isinstance(v, dict) else v
         for k, v in data.items()}
    out = {}
    meshes = {"t4": make_mesh(MeshSpec(tensor=4), "cpu"),
              "d2t2": make_mesh(MeshSpec(data=2, tensor=2), "cpu"),
              "e2t2": make_mesh(MeshSpec(tensor=2, expert=2), "cpu")}

    def run(key, build, cfg, mesh, **kw):
        inputs = t[key + "_in"]
        den, module = build(_fp32(cfg), t[key.split("_")[0] + "_state"], mesh=meshes[mesh], **kw)
        cond = {k: v for k, v in inputs.items() if k not in ("x", "t")}
        out[key] = den.apply(inputs["x"], inputs["t"], cond)
        return module

    module = run("unet_t4", tzoo.build_unet, tunet.TINY_UNET_CONFIG, "t4", tp_axis="tensor")
    out["unet_t4_shapes"] = (tuple(module.down_0_0_attn.blocks[0].attn1.to_qkv.weight.shape),
                             tuple(module.mid_attn.blocks[0].attn1.to_qkv.weight.shape),
                             tuple(module.mid_attn.kv_cross.shape))
    run("unet_d2t2", tzoo.build_unet, tunet.TINY_UNET_CONFIG, "d2t2", tp_axis="tensor")
    module = run("dit_t4", tzoo.build_dit, tdit.TINY_DIT_CONFIG, "t4", tp_axis="tensor")
    out["dit_t4_shapes"] = tuple(module.single[0].linear1.weight.shape)
    run("sd3_t4", tzoo.build_sd3, tsd3.TINY_SD3_CONFIG, "t4", tp_axis="tensor")
    module = run("hidream_e2t2", tzoo.build_hidream, thd.TINY_HIDREAM_CONFIG, "e2t2",
                 tp_axis="tensor", expert_axis="expert")
    out["hidream_e2t2_shapes"] = tuple(module.single[0].ff_i.experts_w1.shape)
    module = run("wan_d2t2_layers", tzoo.build_wan, twan.TINY_WAN_CONFIG, "d2t2",
                 tp_axis="tensor", layer_axis="data")
    out["wan_d2t2_layers_held"] = [not block.ffn_0.weight.is_meta for block in module.blocks]
    return out


# --------------------------------------------------------------------------
# the JAX side and the inputs


def _weights(shapes, seed):
    """Random weights in a flax tree's shapes (fan-in from the contracted
    dim: a conv kernel's H * W * I, else axis -2)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            conv = name == "kernel" and len(s.shape) == 4
            fan_in = int(np.prod(s.shape[:3])) if conv else s.shape[-2]
            v = 0.5 * rng.standard_normal(s.shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _family(name):
    """(JAX builder, JAX tiny config, JAX rules, mesh spec of JAX's
    forward) of a case of TOL."""
    from lanpaint_tpu.models import dit as jdit
    from lanpaint_tpu.models import hidream as jhd
    from lanpaint_tpu.models import sd3 as jsd3
    from lanpaint_tpu.models import unet as junet
    from lanpaint_tpu.models import wan as jwan
    from lanpaint_tpu.models import zoo as jzoo
    from lanpaint_tpu.parallel import MeshSpec as JSpec
    from lanpaint_tpu.parallel import mesh as jm

    return {
        "unet_t4": (jzoo.build_unet, junet.TINY_UNET_CONFIG, jm.unet_tp_rules(),
                    JSpec(data=2, tensor=4)),
        "unet_d2t2": (jzoo.build_unet, junet.TINY_UNET_CONFIG, jm.unet_tp_rules(),
                      JSpec(data=2, tensor=2)),
        "dit_t4": (jzoo.build_dit, jdit.TINY_DIT_CONFIG, jm.dit_tp_rules(),
                   JSpec(data=2, tensor=4)),
        "sd3_t4": (jzoo.build_sd3, jsd3.TINY_SD3_CONFIG, jm.sd3_tp_rules(),
                   JSpec(data=2, tensor=4)),
        "hidream_e2t2": (jzoo.build_hidream, jhd.TINY_HIDREAM_CONFIG, jm.hidream_ep_rules(),
                         JSpec(data=2, tensor=2, expert=2)),
        "wan_d2t2_layers": (jzoo.build_wan, jwan.TINY_WAN_CONFIG,
                            jm.layer_shard_rules(jm.wan_tp_rules()), JSpec(data=2, tensor=2)),
    }[name]


def _inputs(name, rng):
    b = 2
    if name.startswith("wan"):
        return {"x": rng.standard_normal((b, 4, 4, 8, 8)), "t": rng.uniform(0.3, 0.9, b),
                "context": rng.standard_normal((b, 8, 32))}
    x = rng.standard_normal((b, 4, 16, 16))
    if name.startswith("unet"):
        return {"x": x, "t": rng.uniform(1.0, 8.0, b), "context": rng.standard_normal((b, 8, 32))}
    cond = {"context": rng.standard_normal((b, 8, 32)), "vec": rng.standard_normal((b, 16))}
    if name.startswith("hidream"):
        cond["llama"] = rng.standard_normal((2, b, 4, 24))
    return {"x": x, "t": rng.uniform(0.3, 0.9, b), **cond}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The inputs, JAX's sharded forwards and the four ranks' results."""
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu.parallel import make_mesh as jmesh
    from lanpaint_tpu.parallel.mesh import shard_params_tp as jshard
    from lanpaint_tpu_torch.models.bridge import params_from_flax
    from test_torch_parallel import run_ranks

    rng = np.random.default_rng(0)
    data, want = {}, {}
    with jax.default_matmul_precision("highest"):
        for seed, name in enumerate(TOL):
            build, cfg, rules, spec = _family(name)
            cfg = dataclasses.replace(cfg, dtype=jnp.float32)
            den, params = build(cfg)
            tree = _weights(params, seed)
            family = name.split("_")[0]
            if family + "_state" not in data:
                data[family + "_state"] = params_from_flax(tree)
                data[family + "_tree"] = tree
            tree = data[family + "_tree"]
            inputs = {k: v.astype(np.float32) for k, v in _inputs(name, rng).items()}
            data[name + "_in"] = inputs
            mesh = jmesh(spec, devices=jax.devices()[:spec.total])
            sharded = jshard(mesh, jax.tree.map(jnp.asarray, tree), rules)
            cond = {k: jnp.asarray(v) for k, v in inputs.items() if k not in ("x", "t")}
            with mesh:
                want[name] = np.asarray(jax.jit(den.raw_apply)(
                    sharded, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]), cond))
    ranks = {k: v for k, v in data.items() if not k.endswith("_tree")}
    got = run_ranks(tmp_path_factory.mktemp("tp"), 4, _tp_ranks, ranks)
    return data, want, got


# --------------------------------------------------------------------------
# the sharded forwards


@pytest.mark.parametrize("name", list(TOL))
def test_sharded_forward_matches_jax_gspmd(tp, name):
    """Every rank returns the whole output, equal on every rank, within
    tests/test_parallel.py's tolerance of JAX's GSPMD forward."""
    _, want, got = tp
    outs = [g[name] for g in got]
    for o in outs[1:]:
        assert torch.equal(o, outs[0]), name
    rtol, atol = TOL[name]
    assert outs[0].shape == want[name].shape
    np.testing.assert_allclose(outs[0].numpy(), want[name], rtol=rtol, atol=atol)


def test_ranks_hold_their_shards(tp):
    """The head rule keeps the tiny UNet's 2-head level-0 transformer whole
    at tensor 4 (to_qkv (96, 32)) while its 4-head middle one splits (3 x
    64 / 4 rows, kv_cross's 2 x 64 / 4 columns); Flux's linear1 is a
    quarter of each of its q | k | v | mlp parts; HiDream's experts are
    (4 / 2, h, 96 / 2); the layer-sharded Wan's data rank d holds block d
    only."""
    _, _, got = tp
    for rank, g in enumerate(got):
        assert g["unet_t4_shapes"] == ((96, 32), (48, 64), (1, 32, 32))
        assert g["dit_t4_shapes"] == ((3 * 64 + 256) // 4, 64)
        assert g["hidream_e2t2_shapes"] == (2, 64, 48)
        data = rank // 2
        assert g["wan_d2t2_layers_held"] == [i == data for i in range(2)]


# --------------------------------------------------------------------------
# the rules against JAX's, outside the spawn


def _jax_full(family):
    """(JAX config, eval_shape tree, JAX rules with their axis sizes) of a
    full-size config."""
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu.models import dit as jdit
    from lanpaint_tpu.models import hidream as jhd
    from lanpaint_tpu.models import sd3 as jsd3
    from lanpaint_tpu.models import unet as junet
    from lanpaint_tpu.parallel import mesh as jm

    key = jax.random.PRNGKey(0)
    if family == "wan":
        from lanpaint_tpu.models import wan as jwan

        cfg = jwan.WAN22_TI2V_5B_CONFIG
        shapes = jax.eval_shape(jwan.WanModel(cfg).init, key,
                                jnp.zeros((1, cfg.in_channels, 1, 4, 4), jnp.float32),
                                jnp.full((1,), 0.5), jnp.zeros((1, 4, cfg.context_dim)))
        return cfg, shapes, jm.wan_tp_rules()
    if family == "sdxl":
        cfg = junet.SDXL_CONFIG
        shapes = jax.eval_shape(junet.UNetModel(cfg).init, key, jnp.zeros((1, 4, 16, 16)),
                                jnp.ones((1,)), jnp.zeros((1, 4, cfg.context_dim)),
                                jnp.zeros((1, cfg.adm_in_channels)))
        return cfg, shapes, jm.unet_tp_rules()
    if family == "flux":
        cfg = jdit.FLUX_DEV_CONFIG
        shapes = jax.eval_shape(jdit.MMDiT(cfg).init, key, jnp.zeros((1, 16, 16, 16)),
                                jnp.full((1,), 0.5), jnp.zeros((1, 4, cfg.context_dim)),
                                jnp.zeros((1, cfg.vec_dim)))
        return cfg, shapes, jm.dit_tp_rules()
    if family == "sd35":
        cfg = jsd3.SD35_LARGE_CONFIG
        shapes = jax.eval_shape(jsd3.SD3MMDiT(cfg).init, key, jnp.zeros((1, 16, 16, 16)),
                                jnp.full((1,), 0.5), jnp.zeros((1, 4, cfg.context_dim)),
                                jnp.zeros((1, cfg.vec_dim)))
        return cfg, shapes, jm.sd3_tp_rules()
    cfg = jhd.HIDREAM_I1_CONFIG
    shapes = jax.eval_shape(jhd.HiDreamModel(cfg).init, key, jnp.zeros((1, 16, 8, 8)),
                            jnp.full((1,), 0.5), jnp.zeros((1, 4, cfg.context_dim)),
                            jnp.zeros((1, cfg.vec_dim)), jnp.zeros((2, 1, 4, cfg.llama_dim)))
    return cfg, shapes, jm.hidream_ep_rules()


PORT = {"sdxl": (tunet.UNetModel, tunet.SDXL_CONFIG, tmesh.unet_tp_rules, {}),
        "flux": (tdit.MMDiT, tdit.FLUX_DEV_CONFIG, tmesh.dit_tp_rules, {}),
        "sd35": (tsd3.SD3MMDiT, tsd3.SD35_LARGE_CONFIG, tmesh.sd3_tp_rules, {}),
        "hidream": (thd.HiDreamModel, thd.HIDREAM_I1_CONFIG, tmesh.hidream_ep_rules,
                    {"expert_axis": "expert"})}


def _port_state(family):
    cls, cfg, _, _ = PORT[family]
    with torch.device("meta"):
        return cls(cfg).state_dict()


def _jax_cuts(shapes, rules, sizes) -> set:
    """{(the port's key, the port's dim, axis)} of every tensor JAX's rules
    cut at `sizes`: stacked leaves unstacked, kernels' dims transposed as
    the bridge does (flax (in, out) -> torch (out, in))."""
    import jax

    from lanpaint_tpu_torch.models import bridge

    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = tuple(p.key for p in path)[1:]  # under "params"
        joined = "/".join(names)
        spec = next((s for pred, s in rules if pred(joined)), None)
        if spec is None:
            continue
        stacked = bridge.is_stacked(names)
        rank = len(leaf.shape) - stacked
        for dim, axis in enumerate(tuple(spec)):
            if axis is None or leaf.shape[dim] % sizes.get(axis, 1) or sizes.get(axis, 1) == 1:
                continue
            assert not (stacked and dim == 0), joined  # no layer axis in these rules
            d = dim - stacked
            if names[-1] == "kernel":
                d = bridge._KERNEL_AXES[rank].index(d)
            for depth in range(leaf.shape[0] if stacked else 1):
                key = bridge.state_key(bridge.unstack(names, depth) if stacked else names)
                out.add((key, d, axis))
    return out


def _port_cuts(state, rules, sizes) -> set:
    specs = tmesh._specs(state, rules)
    return {(k, d, cut[0]) for k, spec in specs.items() if spec is not None
            for d, cut in enumerate(tmesh._cuts(k, tuple(state[k].shape), spec, sizes))
            if cut is not None}


@pytest.mark.parametrize("family", [*PORT, "wan"])
def test_rules_cut_the_tensors_jax_cuts(family):
    """The same tensors cut on the same dims over the same axes, at sizes
    where no head rule bites (tensor 2, HiDream's expert 2 too)."""
    _, shapes, jrules = _jax_full(family)
    sizes = {"tensor": 2, "expert": 2}
    want = _jax_cuts(shapes, jrules, sizes)
    if family == "wan":
        with torch.device("meta"):
            state = twan.WanModel(twan.WAN22_TI2V_5B_CONFIG).state_dict()
        got = _port_cuts(state, tmesh.wan_tp_rules(), sizes)
    else:
        got = _port_cuts(_port_state(family), PORT[family][2](PORT[family][1]), sizes)
    assert got == want, (sorted(got - want)[:4], sorted(want - got)[:4])
    assert len(got) > 50


def _meta_rank_bytes(family, t, e):
    """Bytes of rank 0's module built on the meta device for a planned
    mesh (bf16)."""
    cls, cfg, _, extra = PORT[family]
    plan = tmesh.plan_mesh(tensor=(t, 0), expert=(e, 0))
    with torch.device("meta"):
        module = cls(cfg, plan, tp_axis="tensor", **extra)
    return sum(2 * v.numel() for v in module.state_dict().values())


@pytest.mark.parametrize("family", list(PORT))
def test_tp_plan_bytes_equal_jax(family):
    """At tensor 1, 2, 4 and 8 (HiDream also at expert 1, 2 and 4): JAX's
    bytes where the head rule does not bite; where it does (BITES), more
    than JAX's, and the bytes of a rank's meta-device module, which holds
    the whole block."""
    from lanpaint_tpu.parallel.mesh import tp_plan_bytes as jbytes

    jcfg, shapes, jrules = _jax_full(family)
    cls, cfg, rules_fn, extra = PORT[family]
    state = _port_state(family)
    bites = set()
    for t in (1, 2, 4, 8):
        for e in ((1, 2, 4) if extra else (1,)):
            sizes = {"tensor": t, "expert": e}
            got = tmesh.tp_plan_bytes(state, rules_fn(cfg), sizes)
            want = jbytes(shapes, jrules, sizes)
            assert got == _meta_rank_bytes(family, t, e), (family, sizes)
            assert tmesh.tp_plan_bytes(state, rules_fn(), sizes) == want, (family, sizes)
            if got != want:
                assert got > want, (family, sizes)
                bites.add((family, t))
    assert bites == {b for b in BITES if b[0] == family}


def test_layer_sharded_wan_plan_equals_jax():
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu.models import wan as jwan
    from lanpaint_tpu.parallel import mesh as jm

    for name in ("TINY_WAN_CONFIG", "WAN22_TI2V_5B_CONFIG", "WAN22_T2V_14B_CONFIG"):
        jcfg = getattr(jwan, name)
        shapes = jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, jcfg.in_channels, 1, 4, 4), jnp.float32),
                                jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)))
        with torch.device("meta"):
            state = twan.WanModel(getattr(twan, name)).state_dict()
        for sizes in ({"tensor": 4, "data": 2}, {"tensor": 2, "data": 4}, {"data": 3},
                      {"data": 8}):
            want = jm.tp_plan_bytes(shapes, jm.layer_shard_rules(jm.wan_tp_rules()), sizes)
            got = tmesh.tp_plan_bytes(state, tmesh.layer_shard_rules(tmesh.wan_tp_rules()),
                                      sizes)
            assert got == want, (name, sizes)


def test_zimage_under_dit_rules_raises():
    """JAX's `dit_tp_rules` name Z-Image but give its 2-D t_mlp_0 / t_mlp_2
    weights a spec for scanned weights: IndexError in JAX, a ValueError
    naming both here."""
    import jax

    from lanpaint_tpu.models import zoo as jzoo
    from lanpaint_tpu.parallel import mesh as jm
    from lanpaint_tpu_torch.models import zimage as tz

    _, params = jzoo.build_tiny_zimage()
    with pytest.raises(IndexError):
        jm.tp_plan_bytes(jax.eval_shape(lambda: params), jm.dit_tp_rules(), {"tensor": 2})
    with torch.device("meta"):
        state = tz.ZImageModel(tz.TINY_ZIMAGE_CONFIG).state_dict()
    for call in (lambda: tmesh.tp_plan_bytes(state, tmesh.dit_tp_rules(), {"tensor": 2}),
                 lambda: tmesh.tp_param_shardings(tmesh.plan_mesh(tensor=(2, 0)), state,
                                                  tmesh.dit_tp_rules())):
        with pytest.raises(ValueError, match=r"t_mlp_0\.weight.*t_mlp_2\.weight"):
            call()


def test_part_aware_shards_and_planned_meshes():
    """A fused projection's shard is the rank's block of each part; the
    shards of all ranks tile the tensor; a layer axis leaves another rank's
    blocks out."""
    w = torch.arange(12 * 2).reshape(12, 2)  # parts q | k | v of 4 rows each
    rules = [(lambda k: k == "blocks.0.to_qkv.weight", tmesh.Spec((tmesh.Cut("tensor", 3),)))]
    shards = [tmesh.shard_params_tp(tmesh.plan_mesh(tensor=(2, r)), {"blocks.0.to_qkv.weight": w},
                                    rules)["blocks.0.to_qkv.weight"] for r in range(2)]
    assert shards[0].tolist() == w[[0, 1, 4, 5, 8, 9]].tolist()
    assert shards[1].tolist() == w[[2, 3, 6, 7, 10, 11]].tolist()
    state = {f"blocks.{i}.w": torch.zeros(2) for i in range(4)} | {"head": torch.zeros(3)}
    layered = tmesh.layer_shard_rules([], axis="data")
    held = [sorted(tmesh.shard_params_tp(tmesh.plan_mesh(data=(2, r)), state, layered))
            for r in range(2)]
    assert held == [["blocks.0.w", "blocks.1.w", "head"], ["blocks.2.w", "blocks.3.w", "head"]]
    three = tmesh.plan_mesh(data=(3, 1))  # 3 does not divide 4: every block on every rank
    assert sorted(tmesh.shard_params_tp(three, state, layered)) == sorted(state)
