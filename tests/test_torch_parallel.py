"""The port's parallel layer (lanpaint_tpu_torch.parallel, the seq- and
tensor-parallel Wan, data parallelism) against the JAX package on the CPU.

The port's side runs as several processes of one `gloo` world, spawned
from the test (a `file://` store under the test's tmp_path, a timeout on
every group, a hard join limit that kills the ranks and fails the test).
The rank functions live at the top of this module, which imports torch and
the port only: a spawned rank re-imports it, and JAX is imported inside the
test bodies.  JAX's side runs on the 8 virtual CPU devices of
tests/conftest.py under `jax.default_matmul_precision("highest")`, with
weights carried across by models/bridge.py.  All configs are fp32.

Tolerances (those of tests/test_parallel.py):
* ring attention and `seq_parallel_attention` against JAX's and against
  full attention: 1e-5;
* the seq-parallel and the seq x tensor-parallel tiny Wan forward against
  JAX's `build_wan_seq_parallel` and JAX's one-device forward: 2e-5;
* the full sampler over the seq-parallel tiny Wan against JAX's
  one-device run through `noise_feed`: 3e-4;
* data parallelism against the port's one-process run with the same seed
  (the fused think step too) and against JAX through `noise_feed`: 1e-5;
* the fused kernels' draw at a rank's element offset against the
  one-process draw's rows: bit for bit;
* `tp_plan_bytes`: exactly JAX's.
"""

import dataclasses
import datetime
import multiprocessing
import os
import tempfile
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lanpaint_tpu_torch import Denoiser, LanPaintConfig, LanPaintSampler, ModelKind
from lanpaint_tpu_torch.models import wan as twan
from lanpaint_tpu_torch.models import zoo as tzoo
from lanpaint_tpu_torch.parallel import (MeshSpec, init_world, make_mesh,
                                         seq_parallel_attention, shard_batch,
                                         shard_params_replicated, tp_plan_bytes, wan_tp_rules,
                                         with_data_parallel)
from lanpaint_tpu_torch.parallel.mesh import batch_sharding, seq_sharding
from lanpaint_tpu_torch.sigmas import EpsSigmaTable, karras

JOIN_S = 300        # the whole spawn, start to join
GROUP_S = 120       # each collective


# --------------------------------------------------------------------------
# spawning a gloo world


def _rank_main(rank, world, store, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_S))
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(directory, world: int, fn, *args) -> list:
    """`fn(rank, *args)` in each of `world` spawned processes of one gloo
    group; returns the ranks' results in rank order."""
    directory = str(directory)
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(directory, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, directory, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks still running after {JOIN_S} s: killed"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    # written by the ranks just spawned (slices among the results)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------
# what the ranks run (torch and the port only)


def _toy_apply(x, t, cond):
    """tests/test_parallel.py's toy denoiser: a per-sample mean shrunk by
    n / (n + t^2)."""
    n = x[0].numel()
    w = n / (n + t.reshape((-1,) + (1,) * (x.ndim - 1)) ** 2)
    c_hat = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True) * w
    return torch.broadcast_to(c_hat, x.shape)


def _toy_sampler(fused=False):
    toy = Denoiser(apply=_toy_apply, kind=ModelKind.EPS, sigma_table=EpsSigmaTable())
    return LanPaintSampler(toy, config=LanPaintConfig(n_steps=2, use_fused_kernels=fused),
                           sampler_name="euler", cfg=1.0)


def _wan_cfg():
    return dataclasses.replace(twan.TINY_WAN_CONFIG, dtype=torch.float32)


def _four_ranks(rank, data):
    """Everything the four-rank world computes, in one spawn."""
    out = {}
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
             tuple(map(torch.from_numpy, v)) if isinstance(v, tuple) else v)
         for k, v in data.items()}

    mesh = make_mesh(MeshSpec(seq=4), "cpu")
    mesh22 = make_mesh(MeshSpec(data=2, seq=2), "cpu")
    out["mesh_shapes"] = [tuple(mesh.shape), tuple(make_mesh(device_type="cpu").shape),
                          tuple(mesh22.shape)]
    out["ring_seq4"] = seq_parallel_attention(mesh, *t["ring_a"])
    out["ring_seq2"] = seq_parallel_attention(mesh22, *t["ring_b"], sm_scale=0.5)

    state = t["wan_state"]
    x, tt, ctx = t["wan_x"], t["wan_t"], t["wan_ctx"]
    den, _ = tzoo.build_wan_seq_parallel(_wan_cfg(), state, mesh)
    out["wan_seq4"] = den.apply(x, tt, {"context": ctx})
    mesh_st = make_mesh(MeshSpec(seq=2, tensor=2), "cpu")
    den, module = tzoo.build_wan_seq_parallel(_wan_cfg(), state, mesh_st, tp_axis="tensor")
    out["wan_seq2_tp2"] = den.apply(x, tt, {"context": ctx})
    out["q_shard"] = (dist.get_rank(mesh_st.get_group("tensor")),
                      module.blocks[0].self_attn.q.weight.clone())

    den, _ = tzoo.build_wan_seq_parallel(_wan_cfg(), state, mesh_st)  # tensor replicated
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), sampler_name="euler", cfg=1.0)
    out["wan_sampler"], _ = sam(latent=t["s_latent"], sigmas=data["s_sigmas"],
                                cond={"context": t["s_ctx"]}, mask=t["s_mask"],
                                noise=t["s_noise"], noise_feed=t["s_feed"], video=True)

    out["placements"] = (batch_sharding(mesh22, (4, 6)), seq_sharding(mesh22, (4, 3, 8), 2),
                         shard_batch(mesh22, torch.arange(8).reshape(4, 2)),
                         shard_batch(mesh22, torch.arange(6).reshape(3, 2)),
                         shard_params_replicated(mesh22, {"w": torch.ones(2)})["w"])
    dp = with_data_parallel(_toy_sampler(), mesh22)
    kw = dict(latent=t["dp_latent"], sigmas=data["dp_sigmas"], cond=t["dp_cond"],
              mask=t["dp_mask"])
    out["dp_seed"] = dp(seed=3, **kw)
    out["dp_feed"] = dp(seed=0, noise=t["dp_noise"], noise_feed=t["dp_feed"], **kw)
    out["dp_fused"] = with_data_parallel(_toy_sampler(fused=True), mesh22)(seed=3, **kw)
    return out


def _axes_ranks(rank, field, state, x, tt, ctx):
    """A tiny Wan built with the parallel axes of `field` on a mesh of its
    own names (two ranks), this rank's share of the forward gathered."""
    from torch.distributed.device_mesh import init_device_mesh

    from lanpaint_tpu_torch.parallel.mesh import all_gather, block, wan_tp_param_specs

    axis = field.get("seq_axis") or field.get("tp_axis")
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=(axis,))
    cfg = dataclasses.replace(_wan_cfg(), **field)
    module = twan.WanModel(cfg, mesh).eval()
    if field.get("tp_axis"):
        state = wan_tp_param_specs(state, rank, 2)
    module.load_state_dict(state)
    with torch.no_grad():
        if field.get("seq_axis"):
            frames = block(x.shape[2], 2, rank)
            vel = module(x[:, :, frames], tt, ctx)
            return all_gather(vel, mesh.get_group(axis), 2)
        return module(x, tt, ctx)


# --------------------------------------------------------------------------
# the JAX side and the inputs


def _jax_wan(seed=7):
    """(flax config, flax tree) of the fp32 tiny Wan, weights from numpy."""
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu.models import wan as jwan
    from test_torch_dit import _random_tree

    jcfg = dataclasses.replace(jwan.TINY_WAN_CONFIG, dtype=jnp.float32)
    x = jnp.zeros((1, 4, 8, 8, 8), jnp.float32)
    shapes = jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.PRNGKey(0), x,
                            jnp.full((1,), 0.5), jnp.zeros((1, 8, 32), jnp.float32))
    return jcfg, _random_tree(shapes, seed)


def _jax_toy():
    import jax.numpy as jnp

    from lanpaint_tpu import Denoiser as JDenoiser
    from lanpaint_tpu import ModelKind as JKind
    from lanpaint_tpu.sigmas import EpsSigmaTable as JTable

    def apply(x, t, cond):
        n = x[0].size
        w = n / (n + t.reshape((-1,) + (1,) * (x.ndim - 1)) ** 2)
        c_hat = jnp.mean(x, axis=tuple(range(1, x.ndim)), keepdims=True) * w
        return jnp.broadcast_to(c_hat, x.shape)

    return JDenoiser(apply=apply, kind=JKind.EPS, sigma_table=JTable())


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The inputs, JAX's results and the four ranks' results."""
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu import LanPaintConfig as JConfig
    from lanpaint_tpu import LanPaintSampler as JSampler
    from lanpaint_tpu.models import zoo as jzoo
    from lanpaint_tpu.parallel import MeshSpec as JSpec
    from lanpaint_tpu.parallel import make_mesh as jmesh
    from lanpaint_tpu.parallel.ring import seq_parallel_attention as jsp
    from lanpaint_tpu_torch.models.bridge import wan_params_from_flax

    rng = np.random.default_rng(0)
    data = {"ring_a": tuple(rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
                            for _ in range(3)),
            "ring_b": tuple(rng.standard_normal((2, 64, 3, 8)).astype(np.float32)
                            for _ in range(3))}
    jcfg, tree = _jax_wan()
    data["wan_state"] = wan_params_from_flax(tree)
    data["wan_x"] = rng.standard_normal((2, 4, 8, 8, 8)).astype(np.float32)
    data["wan_t"] = np.full((2,), 0.7, np.float32)
    data["wan_ctx"] = rng.standard_normal((2, 8, 32)).astype(np.float32)
    shape = (1, 4, 8, 8, 8)
    mask = np.zeros(shape, np.float32)
    mask[..., 4:] = 1.0
    data.update(s_latent=rng.standard_normal(shape).astype(np.float32), s_mask=mask,
                s_noise=rng.standard_normal(shape).astype(np.float32),
                s_ctx=rng.standard_normal((1, 8, 32)).astype(np.float32),
                s_sigmas=np.asarray([0.99, 0.6, 0.0], np.float32))
    data["s_feed"] = rng.standard_normal((2, 2, 5) + shape).astype(np.float32)
    dp_shape = (4, 4, 8, 8)
    dp_mask = np.zeros(dp_shape, np.float32)
    dp_mask[..., 4:] = 1.0
    data.update(dp_latent=rng.standard_normal(dp_shape).astype(np.float32), dp_mask=dp_mask,
                dp_cond=np.zeros((4, 1), np.float32),
                dp_sigmas=karras(6, 0.03, 14.6).astype(np.float32),
                dp_noise=rng.standard_normal(dp_shape).astype(np.float32))
    data["dp_feed"] = rng.standard_normal((5, 2, 5) + dp_shape).astype(np.float32)

    want = {}
    with jax.default_matmul_precision("highest"):
        q, k, v = (jnp.asarray(a) for a in data["ring_a"])
        want["ring_seq4"] = (jsp(jmesh(JSpec(seq=4), devices=jax.devices()[:4]), q, k, v),
                             jax.nn.dot_product_attention(q, k, v))
        q, k, v = (jnp.asarray(a) for a in data["ring_b"])
        want["ring_seq2"] = (
            jsp(jmesh(JSpec(data=2, seq=2), devices=jax.devices()[:4]), q, k, v, sm_scale=0.5),
            jax.nn.dot_product_attention(q, k, v, scale=0.5))
        den, params = jzoo.build_wan(jcfg, tree)
        x, tt = jnp.asarray(data["wan_x"]), jnp.asarray(data["wan_t"])
        cond = {"context": jnp.asarray(data["wan_ctx"])}
        single = jax.jit(den.raw_apply)(params, x, tt, cond)
        sp, _ = jzoo.build_wan_seq_parallel(jcfg, tree, jmesh(JSpec(seq=4),
                                                              devices=jax.devices()[:4]))
        want["wan_seq4"] = (jax.jit(sp.raw_apply)(sp.params, x, tt, cond), single)
        sp, _ = jzoo.build_wan_seq_parallel(
            jcfg, tree, jmesh(JSpec(seq=2, tensor=2), devices=jax.devices()[:4]),
            tp_axis="tensor")
        want["wan_seq2_tp2"] = (jax.jit(sp.raw_apply)(sp.params, x, tt, cond), single)
        sam = JSampler(den, config=JConfig(n_steps=2), sampler_name="euler", cfg=1.0)
        want["wan_sampler"], _ = sam(
            latent=jnp.asarray(data["s_latent"]), sigmas=data["s_sigmas"],
            cond={"context": jnp.asarray(data["s_ctx"])}, mask=jnp.asarray(mask),
            noise=jnp.asarray(data["s_noise"]), noise_feed=jnp.asarray(data["s_feed"]),
            video=True)
        sam = JSampler(_jax_toy(), config=JConfig(n_steps=2), sampler_name="euler", cfg=1.0)
        want["dp_feed"], _ = sam(
            latent=jnp.asarray(data["dp_latent"]), sigmas=data["dp_sigmas"],
            cond=jnp.asarray(data["dp_cond"]), mask=jnp.asarray(dp_mask), seed=0,
            noise=jnp.asarray(data["dp_noise"]), noise_feed=jnp.asarray(data["dp_feed"]))
    want = jax.tree.map(np.asarray, want)
    got = run_ranks(tmp_path_factory.mktemp("four"), 4, _four_ranks, data)
    return data, want, got


def _same_on_every_rank(got, key):
    outs = [g[key] for g in got]
    for o in outs[1:]:
        for a, b in zip(outs[0] if isinstance(outs[0], tuple) else (outs[0],),
                        o if isinstance(o, tuple) else (o,)):
            assert torch.equal(a, b), key
    return outs[0]


# --------------------------------------------------------------------------
# tests


def test_mesh_wrong_size_raises():
    with pytest.raises(ValueError, match="devices"):
        make_mesh(MeshSpec(data=3), "cpu")


def test_mesh_spec_matches_jax():
    from lanpaint_tpu.parallel import MeshSpec as JSpec

    for kw in ({}, dict(data=2, seq=4), dict(data=2, tensor=2, expert=2)):
        assert dataclasses.asdict(MeshSpec(**kw)) == dataclasses.asdict(JSpec(**kw))
        assert MeshSpec(**kw).total == JSpec(**kw).total


def test_mesh_creation(four):
    _, _, got = four
    for g in got:
        assert g["mesh_shapes"] == [(1, 4, 1, 1), (4, 1, 1, 1), (2, 2, 1, 1)]


def test_each_rank_keeps_its_block(four):
    """On the (data 2, seq 2) mesh, rank r is at data r // 2, seq r % 2:
    its rows and frames, a batch "data" does not divide kept whole, and
    replicated parameters copied whole."""
    _, _, got = four
    for rank, g in enumerate(got):
        rows, frames, kept, whole, w = g["placements"]
        d, q = divmod(rank, 2)
        assert rows == (slice(2 * d, 2 * d + 2), slice(None))
        assert frames == (slice(2 * d, 2 * d + 2), slice(None), slice(4 * q, 4 * q + 4))
        assert torch.equal(kept, torch.arange(8).reshape(4, 2)[2 * d:2 * d + 2])
        assert torch.equal(whole, torch.arange(6).reshape(3, 2))
        assert torch.equal(w, torch.ones(2))


@pytest.mark.parametrize("key", ["ring_seq4", "ring_seq2"])
def test_ring_attention_matches_jax_and_full_attention(four, key):
    _, want, got = four
    out = _same_on_every_rank(got, key).numpy()
    for ref in want[key]:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["wan_seq4", "wan_seq2_tp2"])
def test_seq_parallel_wan_matches_jax(four, key):
    _, want, got = four
    out = _same_on_every_rank(got, key).numpy()
    assert out.shape == (2, 4, 8, 8, 8)
    for ref in want[key]:
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_tensor_ranks_hold_their_half_of_q(four):
    data, _, got = four
    full = data["wan_state"]["blocks.0.self_attn.q.weight"]
    ranks = set()
    for g in got:
        t_rank, shard = g["q_shard"]
        ranks.add(t_rank)
        assert tuple(shard.shape) == (32, 64)
        assert torch.equal(shard, full[32 * t_rank:32 * (t_rank + 1)])
    assert ranks == {0, 1}


def test_seq_parallel_sampler_matches_jax(four):
    data, want, got = four
    out = _same_on_every_rank(got, "wan_sampler").numpy()
    np.testing.assert_allclose(out, want["wan_sampler"], rtol=3e-4, atol=3e-4)
    known = data["s_mask"] == 0
    np.testing.assert_allclose(out[known], data["s_latent"][known], atol=1e-5)


def test_data_parallel_matches_one_process(four):
    data, want, got = four
    kw = dict(latent=torch.from_numpy(data["dp_latent"]), sigmas=data["dp_sigmas"],
              cond=torch.from_numpy(data["dp_cond"]), mask=torch.from_numpy(data["dp_mask"]))
    samples, history = _toy_sampler()(seed=3, **kw)
    got_samples, got_history = _same_on_every_rank(got, "dp_seed")
    np.testing.assert_allclose(got_samples.numpy(), samples.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_history.numpy(), history.numpy(), rtol=1e-5, atol=1e-5)
    assert got_samples.shape == (4, 4, 8, 8) and got_history.shape[1] == 4
    fed, _ = _same_on_every_rank(got, "dp_feed")
    np.testing.assert_allclose(fed.numpy(), want["dp_feed"], rtol=1e-5, atol=1e-5)


def test_data_parallel_fused_matches_one_process(four):
    """The fused think step (its plain versions on the CPU, each rank's
    normals its rows of the whole batch's draw) under `with_data_parallel`
    gives the one-process run with the same seed."""
    data, _, got = four
    kw = dict(latent=torch.from_numpy(data["dp_latent"]), sigmas=data["dp_sigmas"],
              cond=torch.from_numpy(data["dp_cond"]), mask=torch.from_numpy(data["dp_mask"]))
    samples, history = _toy_sampler(fused=True)(seed=3, **kw)
    got_samples, got_history = _same_on_every_rank(got, "dp_fused")
    np.testing.assert_allclose(got_samples.numpy(), samples.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_history.numpy(), history.numpy(), rtol=1e-5, atol=1e-5)


def test_data_parallel_refuses_the_semantic_stop():
    toy = Denoiser(apply=_toy_apply, kind=ModelKind.EPS, sigma_table=EpsSigmaTable())
    sam = LanPaintSampler(toy, config=LanPaintConfig(n_steps=2, inner_threshold=0.1))
    with pytest.raises(ValueError, match="semantic stop"):
        with_data_parallel(sam, mesh=None)


@pytest.mark.parametrize("b, m, ranks", [(4, 1000, 2), (4, 1001, 2), (3, 1001, 3),
                                         (6, 7, 3), (4, 4 * 128 * 128, 4)])
def test_data_parallel_fused_draw_is_the_one_process_draw(b, m, ranks):
    """The fused kernels key their normals by the element's index in the
    whole batch: the draw of each rank's rows at element offset rows.start
    * M (what the engine passes for a `BatchRows` generator) is the
    one-process draw's rows, offsets that are not multiples of 4 (M = 1001,
    7) included, so `with_data_parallel` takes `use_fused_kernels`."""
    from lanpaint_tpu_torch.ops.fused import philox_normals
    from lanpaint_tpu_torch.parallel.mesh import block

    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64)
    whole = philox_normals(seed, 5, b, m)
    offsets = []
    for r in range(ranks):
        rows = block(b, ranks, r)
        offsets.append(rows.start * m)
        got = philox_normals(seed, 5, rows.stop - rows.start, m, offset=rows.start * m)
        assert torch.equal(got, whole[:, rows]), (r, rows)
    assert any(o % 4 for o in offsets) == (m % 4 != 0)
    toy = Denoiser(apply=_toy_apply, kind=ModelKind.EPS, sigma_table=EpsSigmaTable())
    sam = LanPaintSampler(toy, config=LanPaintConfig(n_steps=2, use_fused_kernels=True))
    mesh = types.SimpleNamespace(device_type="cpu", mesh_dim_names=("data",), size=lambda d: 1,
                                 get_group=lambda axis: None)
    assert callable(with_data_parallel(sam, mesh))


def test_init_world_cleans_up(tmp_path, monkeypatch):
    """A world of one over a file store: initialized inside the context,
    destroyed and its store directory removed on exit."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with init_world("cpu"):
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo" and len(list(tmp_path.iterdir())) == 1
    assert not dist.is_initialized() and not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["TINY_WAN_CONFIG", "WAN22_TI2V_5B_CONFIG",
                                  "WAN22_T2V_14B_CONFIG"])
def test_tp_plan_bytes_equal_jax(name):
    """Bytes per device under the Wan rules at tensor 1, 2, 4 and 8: the
    port's meta-device state dict against JAX's `eval_shape` tree."""
    import jax
    import jax.numpy as jnp

    from lanpaint_tpu.models import wan as jwan
    from lanpaint_tpu.parallel.mesh import tp_plan_bytes as jbytes
    from lanpaint_tpu.parallel.mesh import wan_tp_rules as jrules

    jcfg = getattr(jwan, name)
    shapes = jax.eval_shape(jwan.WanModel(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jcfg.in_channels, 1, 4, 4), jnp.float32),
                            jnp.full((1,), 0.5), jnp.zeros((1, 4, jcfg.context_dim)))
    with torch.device("meta"):
        state = twan.WanModel(getattr(twan, name)).state_dict()
    for size in (1, 2, 4, 8):
        want = jbytes(shapes, jrules(), {"tensor": size})
        assert tp_plan_bytes(state, wan_tp_rules(), {"tensor": size}) == want, (name, size)
    if name != "TINY_WAN_CONFIG":  # the tiny model's unsharded embeddings dominate
        assert tp_plan_bytes(state, wan_tp_rules(), {"tensor": 2}) < 0.56 * tp_plan_bytes(
            state, wan_tp_rules(), {"tensor": 1})
