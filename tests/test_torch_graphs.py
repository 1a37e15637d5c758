"""CUDA graphs of the UNet's forward (`lanpaint_tpu_torch.models.graphs`,
`UNetModel.forward`): the signature key, the conditions under which a
forward takes the eager path, the least-recently-used cap, the graphs
dropped with the weights, the launch counters and the names by which the
card's trace counts the kernels; and on a CUDA card, the replayed forward
against the eager one.

On the CPU a stub stands in for the capture and the replay (`stub`): a
"capture" runs the call once and a "replay" runs it again on the static
inputs, so everything around the graph runs as on the card.  The card
tests run there without this directory's conftest (which imports JAX):
`python -m pytest tests/test_torch_graphs.py --noconftest -c
portbench/tests/pytest.ini --rootdir . -p no:cacheprovider`."""

import dataclasses
import threading

import pytest
import torch

from lanpaint_tpu_torch import parallel, telemetry
from lanpaint_tpu_torch.models import graphs, unet, zoo
from lanpaint_tpu_torch.ops import attention, fused, norms

TINY = dataclasses.replace(unet.TINY_UNET_CONFIG, dtype=torch.float32)
# SDXL's widths, heads and conditioning, one transformer block a level
SDXL_ONE_DEPTH = dataclasses.replace(unet.SDXL_CONFIG, transformer_depth=(0, 1, 1),
                                     transformer_depth_middle=1)


_CARD_IDLE = graphs._card_idle  # the real check, before `stub` replaces it


class _StubGraph:
    """`torch.cuda.CUDAGraph` on the CPU: a replay recomputes the captured
    call into its static output, leaving the kernel wrappers' counters as
    they were (a graph's launches pass no wrapper)."""

    def __init__(self, fn, args, output):
        self.fn, self.args, self.output = fn, args, output
        self.resets = 0

    def replay(self):
        wrappers = _wrappers()
        before = [f.launches for f in wrappers]
        self.output.copy_(self.fn(*self.args))
        for f, n in zip(wrappers, before):
            f.launches = n

    def reset(self):
        self.resets += 1


def _wrappers():
    return (attention.flash_attention, attention.wide_attention, norms.layernorm, norms.rmsnorm,
            fused.fused_half_step, fused.fused_finish)


@pytest.fixture
def stub(monkeypatch):
    """The CPU as the card: CPU tensors take graphs (grad and one device
    still checked) and a capture runs the call once as the warm-up and
    once more as the "capture".  Yields the stub graphs captured, oldest
    first."""
    captured = []

    def capture(fn, args, device):
        warm = fn(*args)
        output = fn(*args)
        captured.append(_StubGraph(fn, args, output))
        return captured[-1], output, warm

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "_card_idle", lambda device: True)
    return captured


def _graph_counters():
    return telemetry.summary()["graphs"]


@pytest.fixture
def counts():
    """The graph counters' change from the test's start."""
    start = _graph_counters()
    return lambda: {k: n - start[k] for k, n in _graph_counters().items()}


def _tiny(seed=0, **kw):
    module = unet.UNetModel(TINY, **kw)
    zoo.init_params_(module, seed=seed, scale=0.2)
    return module.eval().requires_grad_(False)


def _inputs(batch=2, seed=1, size=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, 4, size, size), generator=g),
            torch.rand((batch,), generator=g) * 999,
            torch.randn((batch, 5, TINY.context_dim), generator=g))


# ---------------------------------------------------------------- signature

def _sdxl_args(batch=2, y=True, kv=("a", "b"), kv_len=77, dtype=torch.float32, strided=False):
    x = torch.zeros((batch, 4, 16, 16), dtype=dtype)
    if strided:
        x = torch.zeros((batch, 16, 16, 4), dtype=dtype).permute(0, 3, 1, 2)
    return (x, torch.zeros(batch), torch.zeros((batch, kv_len, 8)),
            torch.zeros((batch, 12)) if y else None, None,
            {k: torch.zeros((batch, 1, kv_len, 16)) for k in kv})


@pytest.mark.parametrize("change", [
    dict(batch=4), dict(dtype=torch.bfloat16), dict(strided=True), dict(y=False),
    dict(kv=("a", "c")), dict(kv=("a",)), dict(kv_len=78)],
    ids=["batch", "dtype", "strides", "no-y", "kv-names", "kv-count", "kv-shape"])
def test_the_signature_tells_apart_what_a_graph_bakes_in(change):
    base, base_tensors = graphs.signature(_sdxl_args())
    assert graphs.signature(_sdxl_args())[0] == base
    key, tensors = graphs.signature(_sdxl_args(**change))
    assert key != base
    hash(key)
    assert len(base_tensors) == 6


def test_the_signature_orders_dict_tensors_by_key_and_refuses_other_values():
    a, b = torch.zeros(1), torch.ones(2)
    key1, t1 = graphs.signature(({"b": b, "a": a},))
    key2, t2 = graphs.signature(({"a": a, "b": b},))
    assert key1 == key2 and t1[0] is a and t2[1] is b
    assert graphs._rebuild(({"b": b, "a": a},), iter([b, a]))[0] == {"a": b, "b": a}
    assert graphs.signature((a, 1.5)) is None
    assert graphs.signature(({1: a, "x": b},)) is None


# ---------------------------------------------------------------- the path

def test_a_signature_runs_eagerly_once_then_is_captured_and_replayed(stub, counts):
    module, args = _tiny(), _inputs()
    want = module._forward(*args)
    with torch.no_grad():
        outs = [module(*args) for _ in range(4)]
    assert all(torch.equal(o, want) for o in outs)
    assert counts() == {"captures": 1, "replays": 2, "eager": 2}
    assert len(stub) == 1 and len(module._graphs) == 1


def test_a_replay_takes_new_inputs_and_its_output_outlives_the_next_call(stub):
    module = _tiny()
    first, second = _inputs(seed=1), _inputs(seed=2)
    with torch.no_grad():
        module(*first)
        module(*first)  # captured
        out1 = module(*first)
        out2 = module(*second)
    assert torch.equal(out2, module._forward(*second))
    assert torch.equal(out1, module._forward(*first))  # not overwritten by the next replay
    assert not torch.equal(out1, out2)
    assert out2.data_ptr() != module._graphs._graphs[next(iter(module._graphs._graphs))] \
        .output.data_ptr()


@pytest.mark.parametrize("condition", ["cpu", "grad", "control", "mesh", "nested"])
def test_each_condition_takes_the_eager_path_and_counts_it(condition, stub, counts,
                                                          monkeypatch):
    """Without the card, with grad on, with ControlNet residuals, built on
    a mesh, or inside another capture: every call eager, no graph."""
    if condition == "cpu":
        monkeypatch.setattr(graphs, "_card_idle", _CARD_IDLE)
    if condition == "nested":  # a capture running on the card's stream
        monkeypatch.setattr(graphs, "_card_idle", lambda device: False)
    mesh = parallel.plan_mesh(tensor=(1, 0)) if condition == "mesh" else None
    module = _tiny(mesh=mesh, tp_axis="tensor" if mesh else None)
    x, t, ctx = _inputs()
    control = None
    if condition == "control":
        control = {"middle": torch.full((2, 64, 4, 4), 0.5)}
    with torch.set_grad_enabled(condition == "grad"):
        outs = [module(x, t, ctx, control=control) for _ in range(3)]
    want = module._forward(x, t, ctx, control=control)
    assert all(torch.equal(o, want) for o in outs)
    assert counts() == {"captures": 0, "replays": 0, "eager": 3}
    assert len(module._graphs) == 0 and not stub


def test_at_most_max_graphs_are_kept_least_recently_used_first_out(stub, counts):
    """Beyond the cap the least recently used graph goes, and its signature
    runs eagerly from then on: signatures in turn never recapture."""
    module = _tiny()
    cap = graphs.MAX_GRAPHS
    sig = {b: _inputs(batch=b) for b in range(1, cap + 3)}
    with torch.no_grad():
        for b in range(1, cap + 1):  # cap graphs, batch 1 first
            module(*sig[b])
            module(*sig[b])
        module(*sig[1])  # batch 1 used last: batch 2 is now the oldest
        for b in (cap + 1, cap + 2):
            module(*sig[b])
            module(*sig[b])
        assert len(module._graphs) == cap
        assert [g.resets for g in stub] == [0, 1, 1] + [0] * (cap - 1)
        assert counts() == {"captures": cap + 2, "replays": 1, "eager": 2 * (cap + 2)}
        outs = [module(*sig[2]) for _ in range(3)]  # dropped: eager, never captured again
        assert all(torch.equal(o, module._forward(*sig[2])) for o in outs)
        assert counts() == {"captures": cap + 2, "replays": 1, "eager": 2 * (cap + 2) + 3}
        module(*sig[cap + 2])  # a kept graph still replays
        assert counts()["replays"] == 2 and len(stub) == cap + 2


@pytest.mark.parametrize("drop", ["to", "float", "to_meta", "load_state_dict"])
def test_moved_or_reloaded_weights_drop_the_graphs(drop, stub, counts):
    module, args = _tiny(), _inputs()
    with torch.no_grad():
        module(*args)
        module(*args)
    assert len(module._graphs) == 1
    if drop == "to":
        module.to(torch.float32)
    elif drop == "float":
        module.float()
    elif drop == "to_meta":
        module.to("meta")
    else:
        module.load_state_dict(_tiny(seed=5).state_dict())
    assert len(module._graphs) == 0 and stub[0].resets == 1
    if drop != "to_meta":
        with torch.no_grad():
            out = module(*args)  # the signature is forgotten too: eager again
        assert counts()["eager"] == 3 and torch.equal(out, module._forward(*args))


def test_the_graphs_follow_build_unet_and_the_denoiser(stub, counts):
    den, module = zoo.build_unet(TINY, device="cpu")
    x, t, ctx = _inputs()
    cond = den.precompute({"context": ctx})
    sigma = torch.tensor([3.0, 3.0])
    outs = [den.apply(x, sigma, cond) for _ in range(3)]
    assert counts() == {"captures": 1, "replays": 1, "eager": 2}
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_the_wrappers_count_what_the_host_issues_and_no_replay(stub):
    """A forward that launches three row norms: the eager call, the
    warm-up and the capture each issue three; the two replays pass no
    wrapper: four calls count nine."""
    def fn(x):
        norms.layernorm.launches += 3
        return x * 2

    runner, x = graphs.Graphs(), torch.ones(3)
    before = norms.layernorm.launches
    with torch.no_grad():
        for _ in range(4):
            runner(fn, x)
    assert norms.layernorm.launches - before == 9
    assert len(runner) == 1


@pytest.mark.parametrize("name, family", [
    ("void (anonymous namespace)::flash_fwd_kernel<64>(CUtensorMap_st, CUtensorMap_st)",
     "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_kernel<128, true>(CUtensorMap_st, CUtensorMap_st)",
     "flash_attention"),
    ("void (anonymous namespace)::wide_fwd_kernel<640>(CUtensorMap_st)", "wide_attention"),
    ("void (anonymous namespace)::row_norm_kernel<__nv_bfloat16, __nv_bfloat16, 2>(__nv_"
     "bfloat16 const*)", "row_norm"),
    ("void row_norm_kernel<float, float, 1>(float const*)", "row_norm"),
    ("void (anonymous namespace)::fused_think_kernel<0, 4>(unsigned long long const*)",
     "fused_half_step"),
    ("void fused_think_kernel<1, 2>(unsigned long long const*)", "fused_finish"),
    ("void fused_think_kernel<2, 4>(unsigned long long const*)", "fused_finish"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64> >(Flash_fwd_params)",
     None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
], ids=["flash", "flash-persistent", "wide", "row-norm", "row-norm-global", "half-step", "warm-finish", "cold-finish",
        "pytorch-flash", "gemm"])
def test_the_card_trace_names_each_hand_written_kernel(name, family):
    assert telemetry.kernel_family(name) == family


def test_wrapper_counts_fold_into_the_families_the_card_trace_counts():
    counts = {"flash_attention": 70, "layernorm": 210, "rmsnorm": 5, "rmsnorm_rope": 4,
              "fused_finish": 1}
    want = {"flash_attention": 70, "wide_attention": 0, "row_norm": 219,
            "fused_half_step": 0, "fused_finish": 1}
    assert telemetry.families(counts) == want
    assert telemetry.families(want) == want


def test_summary_carries_the_graph_counters(stub):
    module, args = _tiny(), _inputs()
    with torch.no_grad():
        for _ in range(3):
            module(*args)
    s = telemetry.summary()["graphs"]
    assert sorted(s) == ["captures", "eager", "replays"]
    assert s["replays"] >= 2


# ---------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_model(name):
    cfg = {"tiny": TINY, "sdxl-one-depth": SDXL_ONE_DEPTH}[name]
    dtype = torch.float32 if name == "tiny" else torch.bfloat16
    _, module = zoo.build_unet(cfg, device="cuda", param_dtype=dtype, seed=3)
    return cfg, module


def _card_inputs(cfg, seed, batch=2):
    """(x, t, context, y, kv_cache) at the config's widths: a 32^2 latent
    for the tiny UNet, SDXL's 128^2 otherwise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = 32 if cfg is TINY else 128
    x = torch.randn((batch, 4, size, size), generator=g, device="cuda")
    t = torch.rand((batch,), generator=g, device="cuda") * 999
    ctx = torch.randn((batch, 77, cfg.context_dim), generator=g, device="cuda")
    y = (None if cfg.adm_in_channels is None
         else torch.randn((batch, cfg.adm_in_channels), generator=g, device="cuda"))
    return x, t, ctx, y


CARD_MODELS = ["tiny", "sdxl-one-depth"]


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_MODELS)
def test_on_the_card_a_replay_equals_the_eager_forward(name, counts):
    """Bit for bit, on the inputs it was captured with and on new ones; the
    returned tensor survives the next call; the forward hooks fire once a
    call."""
    _card()
    cfg, module = _card_model(name)
    fired = []
    module.register_forward_pre_hook(lambda m, a: fired.append("pre"))
    module.register_forward_hook(lambda m, a, o: fired.append("post"))
    with torch.no_grad():
        first = _card_inputs(cfg, 1)
        kv = zoo.unet_precompute_kv(module, {"context": first[2]})["kv_cache"]
        want = module._forward(*first, kv_cache=kv)
        outs = [module(*first, kv_cache=kv) for _ in range(3)]  # eager, warm-up, replay
        second = _card_inputs(cfg, 2)
        kv2 = zoo.unet_precompute_kv(module, {"context": second[2]})["kv_cache"]
        new = module(*second, kv_cache=kv2)
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)  # outs[2] survived the next replay
        assert torch.equal(new, module._forward(*second, kv_cache=kv2))
        assert not torch.equal(new, want)
    assert fired == ["pre", "post"] * 4
    assert counts() == {"captures": 1, "replays": 2, "eager": 2}


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_MODELS)
def test_on_the_card_replays_count_the_eager_forwards_launches(name):
    """The card's trace of 5 replays holds as many of each hand-written
    kernel as the wrappers count for 5 eager forwards, and as its trace of
    them; the replays issue none through the wrappers."""
    _card()
    cfg, module = _card_model(name)
    args = _card_inputs(cfg, 1)
    with torch.no_grad():
        module(*args)
        module(*args)  # captured
        before = telemetry.launches()
        with telemetry.card_kernels() as replayed:
            for _ in range(5):
                module(*args)
        issued = telemetry.launches()
        with telemetry.card_kernels() as eager:
            for _ in range(5):
                module._forward(*args)
        counted = {k: n - issued[k] for k, n in telemetry.launches().items()}
    assert issued == before
    assert replayed == eager == telemetry.families(counted)
    assert eager["row_norm"] > 0
    if name != "tiny":  # the tiny UNet's 16-wide heads take the plain attention
        assert eager["flash_attention"] > 0


@pytest.mark.card
def test_on_the_card_to_meta_frees_the_graph_pool():
    _card()
    cfg, module = _card_model("sdxl-one-depth")
    args = _card_inputs(cfg, 1)
    weights = sum(p.numel() * p.element_size() for p in module.parameters())
    with torch.no_grad():
        module(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        eager = torch.cuda.memory_reserved()
        module(*args)
        module(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graphed = torch.cuda.memory_reserved()
    assert graphed > eager  # the pool
    module.to("meta")
    torch.cuda.empty_cache()
    assert len(module._graphs) == 0
    assert graphed - torch.cuda.memory_reserved() >= weights + 0.5 * (graphed - eager)


@pytest.mark.card
def test_on_the_card_a_capture_survives_cuda_work_on_another_thread(counts):
    _card()
    cfg, module = _card_model("sdxl-one-depth")
    args = _card_inputs(cfg, 1)
    stop, done = threading.Event(), []

    def busy():
        a = torch.randn((1024, 1024), device="cuda")
        while not stop.is_set():
            a = torch.tanh(a @ a.T * 1e-3)
            done.append(float(a.sum()))  # a copy to the host and its wait

    with torch.no_grad():
        want = module._forward(*args)
        worker = threading.Thread(target=busy)
        worker.start()
        try:
            outs = [module(*args) for _ in range(3)]
            torch.cuda.synchronize()
        finally:
            stop.set()
            worker.join(timeout=60)
    assert not worker.is_alive() and done
    assert all(torch.equal(o, want) for o in outs)
    assert counts()["captures"] == 1
