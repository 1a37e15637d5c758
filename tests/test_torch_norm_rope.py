"""RoPE in the row-norm kernel's RMS epilogue (`ops.norms.rmsnorm_rope`).

The DiTs' q and k norms rotate their output by the `rope_freqs` table in
the same launch (`csrc/row_norm.cu`, the ROPE instantiations), in place of
`apply_rope` after the norm.  The kernel runs only on the card; on the CPU
these tests hold what surrounds it:

* the plain twin `rmsnorm_rope_ref` against the unfused composition the
  models ran before, `apply_rope(rmsnorm_ref(...))`, bit for bit, at every
  caller's layout (Flux's single-block `linear1` views, the double block's
  txt and img thirds with their slices of the table, Wan's full-width
  rows), bf16 and fp32;
* `rope_geometry` at the callers' full sizes, and a CPU emulation of the
  kernel's addressing and epilogue arithmetic built from it: it reads
  exactly the table rows `apply_rope` reads and gives the twin's output bit
  for bit;
* the wrapper's refusals before any launch;
* the tiny DiT's and tiny Wan's forwards against the unfused blocks.

Cards tests (`card`, skipped without one) hold the kernel to `rmsnorm` +
`apply_rope` on the card at the cells' shapes, bit for bit, and count the
RoPE launches of a Flux and a Wan forward.  They run there without this
directory's conftest (which imports JAX): `python -m pytest
tests/test_torch_norm_rope.py --noconftest -c portbench/tests/pytest.ini
--rootdir . -p no:cacheprovider`.
"""

import dataclasses

import pytest
import torch

from lanpaint_tpu_torch.models import dit, layers, wan, zoo
from lanpaint_tpu_torch.ops import norms

D = 128


def _table(b, s, axes=(16, 56, 56), seed=0, device="cpu"):
    """A (b, s, sum(axes) / 2, 2, 2) table of `rope_freqs` over seeded ids."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 64, (b, s, len(axes)), generator=gen)
    return layers.rope_freqs(ids, axes).to(device)


def _normal(shape, seed, dtype, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 2.0 + 0.5).to(device=device, dtype=dtype)


def _gamma(c, seed=1, dtype=torch.bfloat16, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return (1.0 + 0.1 * torch.randn(c, generator=gen)).to(device=device, dtype=dtype)


def _case(layout, dtype, device="cpu", heads=4, s_img=40, s_txt=12, batch=1):
    """(x, freqs, the unfused composition's output) of a caller's layout,
    small on the CPU: per-head rows of a fused projection (Flux) or dense
    full-width rows (Wan)."""
    c = heads * D
    s_all = s_txt + s_img
    if layout == "wan_full_width":
        x = _normal((batch, s_all, c), 2, dtype, device)
        pe = _table(batch, s_all, (44, 42, 42), device=device)
        want = lambda y: layers.apply_rope(y.unflatten(-1, (heads, D)), pe).flatten(2)  # noqa
        return x, pe, want
    pe = _table(batch, s_all, device=device)
    if layout == "flux_single_linear1":  # linear1 = q | k | v | mlp, k's columns
        fused = _normal((batch, s_all, 3 * c + 4 * c), 3, dtype, device)
        x = fused[..., c:2 * c].unflatten(-1, (heads, D))
        return x, pe, lambda y: layers.apply_rope(y, pe)
    # the double block's qkv thirds: the txt or img stream's q with its
    # rows of the table, as the joint attention's [txt; img] order has them
    n = s_txt if layout == "flux_double_txt" else s_img
    fused = _normal((batch, n, 3 * c), 4, dtype, device)
    x = fused[..., :c].unflatten(-1, (heads, D))
    pe_rows = pe[:, :s_txt] if layout == "flux_double_txt" else pe[:, s_txt:]
    return x, pe_rows, lambda y: layers.apply_rope(y, pe_rows)


LAYOUTS = ["flux_single_linear1", "flux_double_txt", "flux_double_img", "wan_full_width"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_twin_is_apply_rope_of_rmsnorm(layout, batch, dtype):
    x, pe, unfused = _case(layout, dtype, batch=batch)
    g = _gamma(x.shape[-1])
    got = norms.rmsnorm_rope_ref(x, g, 1e-6, pe, D)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, unfused(norms.rmsnorm_ref(x, g, 1e-6)))
    # the CPU wrapper is the twin, and launches nothing
    assert torch.equal(norms.rmsnorm_rope(x, g, 1e-6, pe, D), got)
    assert norms.rmsnorm_rope.launches == 0


def test_double_block_streams_rotated_apart_equal_the_joint_rotation():
    """The double block rotates txt and img each by its slice of the table
    and joins them after: the old joint `apply_rope(cat(...), pe)`."""
    heads, s_txt, s_img = 3, 9, 30
    pe = _table(2, s_txt + s_img)
    txt = _normal((2, s_txt, 3 * heads * D), 5, torch.bfloat16)[..., :heads * D]
    img = _normal((2, s_img, 3 * heads * D), 6, torch.bfloat16)[..., :heads * D]
    txt, img = (t.unflatten(-1, (heads, D)) for t in (txt, img))
    g = _gamma(D)
    joint = layers.apply_rope(torch.cat([norms.rmsnorm_ref(txt, g), norms.rmsnorm_ref(img, g)],
                                        dim=1), pe)
    apart = torch.cat([norms.rmsnorm_rope(txt, g, 1e-6, pe[:, :s_txt], D),
                       norms.rmsnorm_rope(img, g, 1e-6, pe[:, s_txt:], D)], dim=1)
    assert torch.equal(apart, joint)


def _meta_table(b, s_all):
    return torch.empty((b, s_all, D // 2, 2, 2), device="meta")


FLUX_LINEAR1 = 3 * 3072 + 4 * 3072
GEOMETRY = {  # name: (x, table, (tok_rows, n_tok, s_b, s_s)) at a main path's full size
    "flux_single_linear1": (
        lambda: torch.empty((1, 4608, FLUX_LINEAR1), device="meta")[..., :3072]
        .unflatten(-1, (24, 128)), lambda: _meta_table(1, 4608), (24, 4608, 0, 256)),
    "flux_double_txt": (
        lambda: torch.empty((1, 512, 3 * 3072), device="meta")[..., :3072].unflatten(-1, (24, 128)),
        lambda: _meta_table(1, 4608)[:, :512], (24, 512, 0, 256)),
    "flux_double_img_b2": (
        lambda: torch.empty((2, 4096, 3 * 3072), device="meta")[..., 3072:6144]
        .unflatten(-1, (24, 128)), lambda: _meta_table(2, 4608)[:, 512:],
        (24, 4096, 4608 * 256, 256)),
    "wan_full_width_b2": (lambda: torch.empty((2, 7920, 3072), device="meta"),
                          lambda: _meta_table(2, 7920), (1, 7920, 7920 * 256, 256)),
    "wan_one_table_for_the_batch": (lambda: torch.empty((2, 7920, 3072), device="meta"),
                                    lambda: _meta_table(1, 7920), (1, 7920, 0, 256)),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_rope_geometry_of_caller_layouts(name):
    make_x, make_table, want = GEOMETRY[name]
    x, pe = make_x(), make_table()
    assert norms.rope_geometry(x.shape, pe.shape, pe.stride(), D) == want


def _index_of(t):
    """The storage offset of each element of `t`, in t's shape."""
    size = t.untyped_storage().nbytes() // t.element_size()
    return torch.arange(size).as_strided(t.shape, t.stride(), t.storage_offset())


def _emulated_table_offsets(x, pe, head_dim):
    """The table offsets the kernel reads for each (row, element) of `x`,
    from `rope_geometry` alone: (rows, C, 4) int64, the four entries
    (t00, t01, t10, t11) of each element's matrix, as `rope8` reads them."""
    tok_rows, n_tok, s_b, s_s = norms.rope_geometry(x.shape, pe.shape, pe.stride(), head_dim)
    c = x.shape[-1]
    r = torch.arange(x.numel() // c)
    tok = r // tok_rows
    base = pe.storage_offset() + (tok // n_tok) * s_b + (tok % n_tok) * s_s
    pair = (torch.arange(c) % head_dim) // 2
    return base[:, None, None] + 4 * pair[None, :, None] + torch.arange(4)[None, None, :]


def _apply_rope_offsets(x, pe, head_dim):
    """The table offsets `apply_rope` reads for each (row, element) of x
    (the batch broadcast where the table has one): (rows, C, 4)."""
    b, s = x.shape[:2]
    idx = _index_of(pe).expand(b, s, head_dim // 2, 2, 2)
    heads = x.numel() // (b * s * head_dim)
    per = idx.reshape(b, s, 1, head_dim // 2, 4).expand(b, s, heads, head_dim // 2, 4)
    # element c = 2 * pair + i takes the pair's matrix whole (its row i of it)
    per = per.repeat_interleave(2, dim=3)
    return per.reshape(-1, x.shape[-1], 4)


def _emulated_kernel(x, gamma, eps, pe, head_dim):
    """The kernel's RoPE epilogue on the CPU: the norm's output rounded to
    x's dtype (as it is stored unfused), widened, each element rotated with
    the table entries its thread reads, t0 * x0 + t1 * x1 as separate fp32
    multiplies and an add, rounded once."""
    c = x.shape[-1]
    y = norms.rmsnorm_ref(x, gamma, eps).reshape(-1, c).float()
    table = torch.empty(0, dtype=pe.dtype).set_(pe.untyped_storage())
    t = table[_emulated_table_offsets(x, pe, head_dim)]  # (rows, C, 4)
    even = torch.arange(0, c, 2)
    x0, x1 = y[:, even], y[:, even + 1]
    out = torch.empty_like(y)
    out[:, even] = t[:, even, 0] * x0 + t[:, even, 1] * x1
    out[:, even + 1] = t[:, even + 1, 2] * x0 + t[:, even + 1, 3] * x1
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_emulated_kernel_reads_apply_ropes_table_rows_and_gives_the_twin(layout, batch, dtype):
    x, pe, _ = _case(layout, dtype, batch=batch)
    assert torch.equal(_emulated_table_offsets(x, pe, D), _apply_rope_offsets(x, pe, D))
    g = _gamma(x.shape[-1])
    assert torch.equal(_emulated_kernel(x, g, 1e-6, pe, D),
                       norms.rmsnorm_rope_ref(x, g, 1e-6, pe, D))


def test_emulated_kernel_shares_a_batch_one_table():
    """A table of batch 1 serves every batch row (s_b = 0), as apply_rope
    broadcasts it."""
    x = _normal((3, 10, 2 * D), 7, torch.bfloat16)
    pe = _table(1, 10)
    assert torch.equal(_emulated_table_offsets(x, pe, D), _apply_rope_offsets(x, pe, D))
    g = _gamma(2 * D)
    assert torch.equal(_emulated_kernel(x, g, 1e-6, pe, D),
                       norms.rmsnorm_rope_ref(x, g, 1e-6, pe, D))


def test_the_wrapper_refuses_before_any_launch():
    """`_launch` checks the table and the layout before it builds or calls
    the kernel, so these raise here, where there is neither a card nor
    nvcc."""
    x = torch.zeros((2, 6, 4, D), dtype=torch.bfloat16)
    pe = _table(2, 6)
    g = torch.ones(D, dtype=torch.bfloat16)
    bad = {  # match: (x, table, head dim, rms, out dtype)
        "D % 8": (torch.zeros((2, 6, 60), dtype=torch.bfloat16), _table(2, 6, (20, 20, 20))[
            ..., :6, :, :], 12, True, None),
        "dividing C": (torch.zeros((2, 6, 200), dtype=torch.bfloat16), pe, D, True, None),
        "table": (x, pe[:, :5], D, True, None),  # the table's tokens are not x's
        "table ": (x, _table(3, 6), D, True, None),  # nor its batch
        "strides": (x, pe.transpose(-1, -2), D, True, None),  # matrices not contiguous
        "(B, S": (x[:, 0, 0], pe, D, True, None),  # no token dim
        "RMS mode": (x, pe, D, False, None),
        "x's dtype": (x, pe, D, True, torch.float32),
        "fp32 table": (x, pe.double(), D, True, None),
    }
    for match, (xx, table, d, rms, out_dtype) in bad.items():
        with pytest.raises(ValueError, match=match.strip().replace("(", r"\(")):
            norms._launch(norms.rmsnorm_rope, xx, g if xx.shape[-1] == D else None, None, 1e-6,
                          rms, out_dtype, rope=(table, d))
    assert norms.rmsnorm_rope.launches == 0 and norms.rmsnorm.launches == 0


# --------------------------------------------------- the models, unfused

def _double_unfused(self, img, txt, vec, pe):
    """DoubleStreamBlock.forward as it ran before the epilogue: QKNorm, then
    `apply_rope` on the joined [txt; img] q and k."""
    dt = self.cfg.dtype
    im1_shift, im1_scale, im1_gate, im2_shift, im2_scale, im2_gate = self.img_mod(vec)
    tx1_shift, tx1_scale, tx1_gate, tx2_shift, tx2_scale, tx2_gate = self.txt_mod(vec)

    def qkv(x, prefix):
        heads = (self.heads, self.cfg.head_dim)
        q, k, v = (t.unflatten(-1, heads)
                   for t in getattr(self, f"{prefix}_attn_qkv")(x).chunk(3, dim=-1))
        q, k = getattr(self, f"{prefix}_attn_qknorm")(q, k)
        return q, k, v

    iq, ik, iv = qkv(dit._modulate(dit.layernorm_na(img), im1_shift, im1_scale).to(dt), "img")
    tq, tk, tv = qkv(dit._modulate(dit.layernorm_na(txt), tx1_shift, tx1_scale).to(dt), "txt")
    q = layers.apply_rope(torch.cat([tq, iq], dim=1), pe)
    k = layers.apply_rope(torch.cat([tk, ik], dim=1), pe)
    v = torch.cat([tv, iv], dim=1)
    attn = dit.attention_bshd(q, k, v).flatten(2)
    n_txt = txt.shape[1]
    img = img + im1_gate * self.img_attn_proj(attn[:, n_txt:])
    txt = txt + tx1_gate * self.txt_attn_proj(attn[:, :n_txt])
    img_n2 = dit._modulate(dit.layernorm_na(img), im2_shift, im2_scale).to(dt)
    txt_n2 = dit._modulate(dit.layernorm_na(txt), tx2_shift, tx2_scale).to(dt)
    img = img + im2_gate * self.img_mlp_2(dit._gelu(self.img_mlp_0(img_n2)))
    txt = txt + tx2_gate * self.txt_mlp_2(dit._gelu(self.txt_mlp_0(txt_n2)))
    return img, txt


def _single_unfused(self, x, vec, pe):
    cfg = self.cfg
    shift, scale, gate = self.modulation(vec)
    fused = self.linear1(dit._modulate(dit.layernorm_na(x), shift, scale).to(cfg.dtype))
    qkv, mlp = fused[..., :3 * self.width], fused[..., 3 * self.width:]
    q, k, v = (t.unflatten(-1, (self.heads, cfg.head_dim)) for t in qkv.chunk(3, dim=-1))
    q, k = self.qknorm(q, k)
    attn = dit.attention_bshd(layers.apply_rope(q, pe), layers.apply_rope(k, pe), v).flatten(2)
    return x + gate * self.linear2(torch.cat([attn, dit._gelu(mlp)], dim=-1))


def _wan_self_unfused(self, x, pe):
    heads = self.heads
    q = layers.apply_rope(self.norm_q(self.q(x)).unflatten(-1, heads), pe)
    k = layers.apply_rope(self.norm_k(self.k(x)).unflatten(-1, heads), pe)
    v = self.v(x).unflatten(-1, heads)
    return self.o(wan.attention_bshd(q, k, v).flatten(2))


def _emulated_rmsnorm_rope(x, gamma, eps, freqs, head_dim):
    """The wrapper with the kernel's addressing and arithmetic emulated."""
    return _emulated_kernel(x, gamma, eps, freqs, head_dim)


@pytest.mark.parametrize("route", ["twin", "emulated_kernel"])
@pytest.mark.parametrize("model", ["tiny_dit", "tiny_wan"])
def test_tiny_forwards_equal_the_unfused_blocks(model, route, monkeypatch):
    """bf16 forwards of the tiny DiT and the tiny Wan at batch 2, through
    the RoPE epilogue (its twin, or the CPU emulation of the kernel's
    addressing at the callers' layouts) and through the blocks as they ran
    before it: equal bit for bit."""
    gen = torch.Generator().manual_seed(0)
    if model == "tiny_dit":
        cfg = dataclasses.replace(dit.TINY_DIT_CONFIG, dtype=torch.bfloat16)
        _, module = zoo.build_dit(cfg, device="cpu", seed=1)
        args = (torch.randn((2, 4, 16, 16), generator=gen), torch.tensor([0.7, 0.3]),
                torch.randn((2, 8, cfg.context_dim), generator=gen),
                torch.randn((2, cfg.vec_dim), generator=gen))
        unfused = {(dit.DoubleStreamBlock, "forward"): _double_unfused,
                   (dit.SingleStreamBlock, "forward"): _single_unfused}
    else:
        cfg = dataclasses.replace(wan.TINY_WAN_CONFIG, dtype=torch.bfloat16)
        _, module = zoo.build_wan(cfg, device="cpu", seed=1)
        args = (torch.randn((2, 4, 2, 8, 8), generator=gen), torch.tensor([0.7, 0.3]),
                torch.randn((2, 8, cfg.context_dim), generator=gen))
        unfused = {(wan.WanSelfAttention, "forward"): _wan_self_unfused}
    if route == "emulated_kernel":
        monkeypatch.setattr(layers, "rmsnorm_rope", _emulated_rmsnorm_rope)
    calls = []
    rope = layers.rmsnorm_rope
    monkeypatch.setattr(layers, "rmsnorm_rope", lambda *a: calls.append(1) or rope(*a))
    with torch.no_grad():
        fused = module(*args)
        n_fused = len(calls)
        with monkeypatch.context() as m:
            for (cls, name), fn in unfused.items():
                m.setattr(cls, name, fn)
            want = module(*args)
    assert n_fused == 2 * (cfg.depth_double * 2 + cfg.depth_single if model == "tiny_dit"
                           else cfg.depth)
    assert len(calls) == n_fused  # the unfused blocks call no epilogue
    assert torch.equal(fused, want)


# ------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the cells' shapes: (x as the caller hands it over, its table)
CARD_CASES = {
    # Wan's full-width q / k rows at the video cell's batch 2
    "wan_b2": lambda: (_normal((2, 7920, 3072), 11, torch.bfloat16, "cuda"),
                       _table(2, 7920, (44, 42, 42), device="cuda")),
    # Flux's single-block q, a view of linear1's output, the whole table
    "flux_single": lambda: (_normal((1, 4608, FLUX_LINEAR1), 12, torch.bfloat16, "cuda")
                            [..., :3072].unflatten(-1, (24, 128)), _table(1, 4608, device="cuda")),
    # the double block's txt k: a third of the txt qkv, the table's first 512 rows
    "flux_txt": lambda: (_normal((1, 512, 3 * 3072), 13, torch.bfloat16, "cuda")
                         [..., 3072:6144].unflatten(-1, (24, 128)),
                         _table(1, 4608, device="cuda")[:, :512]),
    # and its img q, the table's rows after them
    "flux_img": lambda: (_normal((1, 4096, 3 * 3072), 14, torch.bfloat16, "cuda")
                         [..., :3072].unflatten(-1, (24, 128)),
                         _table(1, 4608, device="cuda")[:, 512:]),
    # fp32 rows, which no cell runs
    "fp32_small": lambda: (_normal((2, 300, 3 * 512), 15, torch.float32, "cuda")
                           [..., :512].unflatten(-1, (4, 128)), _table(2, 300, device="cuda")),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_on_the_card_the_epilogue_equals_rmsnorm_then_apply_rope(name):
    _card()
    x, pe = CARD_CASES[name]()
    g = _gamma(x.shape[-1], device="cuda")
    before = (norms.rmsnorm_rope.launches, norms.rmsnorm.launches)
    got = norms.rmsnorm_rope(x, g, 1e-6, pe, D)
    unfused = norms.rope_rows(norms.rmsnorm(x, g, 1e-6), pe, D)
    torch.cuda.synchronize()
    assert (norms.rmsnorm_rope.launches, norms.rmsnorm.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, unfused)


@pytest.mark.card
@pytest.mark.parametrize("model", ["flux", "wan"])
def test_on_the_card_a_forward_launches_the_epilogue_and_no_apply_rope(model, monkeypatch):
    """Flux's and TI2V-5B's depths at a narrow width (2 heads of 128): 152
    RoPE launches a Flux forward (4 a double block, 2 a single one), 60 a
    Wan forward (self q and k of 30 blocks), as `telemetry.summary()`
    reports them, and `apply_rope` never called on a CUDA tensor."""
    _card()
    from lanpaint_tpu_torch import telemetry

    on_card = []
    rope = norms.apply_rope
    monkeypatch.setattr(norms, "apply_rope",
                        lambda x, f: on_card.append(x.is_cuda) or rope(x, f))
    gen = torch.Generator().manual_seed(0)
    if model == "flux":
        cfg = dataclasses.replace(dit.FLUX_DEV_CONFIG, hidden=256, num_heads=2, context_dim=64,
                                  vec_dim=32)
        _, module = zoo.build_dit(cfg, device="cuda", seed=1)
        args = (torch.randn((1, 16, 64, 64), generator=gen), torch.tensor([0.7]),
                torch.randn((1, 16, 64), generator=gen), torch.randn((1, 32), generator=gen),
                torch.tensor([3.5]))
        want = 4 * 19 + 2 * 38
    else:
        cfg = dataclasses.replace(wan.WAN22_TI2V_5B_CONFIG, hidden=256, num_heads=2, ffn_dim=512,
                                  context_dim=64)
        _, module = zoo.build_wan(cfg, device="cuda", seed=1)
        args = (torch.randn((2, 48, 3, 16, 16), generator=gen), torch.tensor([0.7, 0.7]),
                torch.randn((2, 16, 64), generator=gen))
        want = 2 * 30
    before = telemetry.summary()["rope_launches"]
    with torch.no_grad():
        out = module(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert telemetry.summary()["rope_launches"] - before == want
    assert torch.isfinite(out).all()
    assert not any(on_card)
