"""How the port's row-norm kernel reads its rows, on the CPU.

`ops.norms.row_geometry` collapses a tensor's leading dims into at most two
row dims, (n_outer, n_inner, s_outer, s_inner); the CUDA kernel
(`csrc/row_norm.cu`) reads row r at (r // n_inner) * s_outer + (r %
n_inner) * s_inner and writes a contiguous output, so QKNorm's strided
(B, S, H, D) views of a fused projection are read in place instead of being
copied first.  The kernel runs only on the card (`chip_smoke.py` checks it
there); these tests hold what surrounds it:

* the geometry of every layout the port's callers hand the row norm,
  recorded through small bf16 MMDiT, Wan and UNet models on the CPU;
* a CPU emulation of the kernel's addressing, which reads exactly the
  storage elements of the tensor's own rows, in their order;
* the refusal of a layout that does not collapse, and of what the kernel
  does not take, before any launch;
* `launch_config`'s block shapes against the kernel's contract;
* the plain versions on strided views against `lanpaint_tpu.ops.norms`'s
  `fused_rmsnorm` / `fused_layernorm` on the contiguous copy, which on the
  CPU take their jnp reference, as `tests/test_norms.py` runs them
  (tolerance: fp32 1e-5; bf16 one ulp of each element, since both sides
  round the same fp32 math once).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.ops import norms as jnorms
from lanpaint_tpu_torch.models import dit, layers, unet, wan, zoo
from lanpaint_tpu_torch.ops import norms as tnorms


def _emulated_rows(x):
    """The storage offsets the kernel reads for each row of `x`, from the
    geometry alone: (rows, C) int64."""
    c = x.shape[-1]
    n_outer, n_inner, s_outer, s_inner = tnorms.row_geometry(x.shape, x.stride())
    r = torch.arange(n_outer * n_inner)
    start = x.storage_offset() + (r // n_inner) * s_outer + (r % n_inner) * s_inner
    return start[:, None] + torch.arange(c)[None, :]


def _own_rows(x):
    """The storage offsets of `x`'s own rows, in order: (rows, C) int64."""
    size = x.untyped_storage().nbytes() // x.element_size()
    index = torch.arange(size).as_strided(x.shape, x.stride(), x.storage_offset())
    return index.reshape(-1, x.shape[-1])


def _fused(b, s, width, cols, device="cpu", dtype=torch.bfloat16):
    """(B, S, width) projection output and its first `cols` columns."""
    return torch.zeros((b, s, width), dtype=dtype, device=device)[..., :cols]


FLUX_LINEAR1 = 3 * 3072 + 4 * 3072  # a Flux single block's linear1 width
LAYOUTS = {  # name: (tensor at a main path's full size, expected geometry)
    # QKNorm's q of a double block: a third of the fused qkv, (B*S, H) rows
    "flux_double_qknorm": (lambda: _fused(1, 4608, 3 * 3072, 3072, "meta").unflatten(-1, (24, 128)),
                           (4608, 24, 3 * 3072, 128)),
    # a single block's q and k: column slices of linear1's output
    "flux_single_qknorm": (lambda: _fused(1, 4608, FLUX_LINEAR1, 3072, "meta")
                           .unflatten(-1, (24, 128)), (4608, 24, FLUX_LINEAR1, 128)),
    "flux_text_qknorm_b2": (lambda: _fused(2, 512, 3 * 3072, 3072, "meta").unflatten(-1, (24, 128)),
                            (1024, 24, 3 * 3072, 128)),
    # Wan's full-width q / k norm and layernorm_na, SDXL's LayerNorm: dense rows
    "wan_full_width": (lambda: torch.empty((1, 7920, 3072), device="meta"), (1, 7920, 0, 3072)),
    "sdxl_layernorm": (lambda: torch.empty((2, 4096, 640), device="meta"), (1, 8192, 0, 640)),
    "one_row": (lambda: torch.empty((128,), device="meta"), (1, 1, 0, 128)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_geometry_of_caller_layouts(name):
    make, want = LAYOUTS[name]
    x = make()
    assert tnorms.row_geometry(x.shape, x.stride()) == want


@pytest.mark.parametrize("layout", ["qkv_third", "linear1_slice", "contiguous", "batch2_slice",
                                    "middle_rows", "size_one_dims"])
def test_emulated_addressing_reads_exactly_the_rows_of_the_copy(layout):
    """The offsets the kernel computes from the geometry are the offsets of
    the tensor's own rows, row by row, and the values there are those of
    `x.reshape(-1, C)` (the copy the Triton kernel made first)."""
    gen = torch.Generator().manual_seed(0)
    make = {
        "qkv_third": lambda: _fused(1, 37, 3 * 4 * 16, 4 * 16).unflatten(-1, (4, 16)),
        "linear1_slice": lambda: _fused(1, 37, 7 * 64, 3 * 64)[..., 64:128].unflatten(-1, (4, 16)),
        "contiguous": lambda: torch.zeros((3, 5, 24), dtype=torch.bfloat16),
        "batch2_slice": lambda: _fused(2, 11, 5 * 32, 96)[..., 32:64].unflatten(-1, (2, 16)),
        "middle_rows": lambda: torch.zeros((4, 9, 16), dtype=torch.bfloat16)[:, 2:7],
        "size_one_dims": lambda: _fused(1, 13, 3 * 48, 48).unflatten(-1, (1, 3, 16))[:, :, :1],
    }[layout]
    x = make()
    base = torch.empty(0, dtype=x.dtype).set_(x.untyped_storage())
    base.copy_(torch.randn(base.shape, generator=gen).to(x.dtype))
    read = _emulated_rows(x)
    assert torch.equal(read, _own_rows(x))
    assert torch.equal(base[read], x.reshape(-1, x.shape[-1]))


def test_geometry_refuses_what_does_not_collapse():
    # every other batch, row and column block: three row dims that do not merge
    x = torch.zeros((4, 6, 8, 16))[::2, ::2, ::2]
    with pytest.raises(ValueError, match="does not collapse"):
        tnorms.row_geometry(x.shape, x.stride())
    with pytest.raises(ValueError, match="unit stride"):
        y = torch.zeros((8, 32)).t()
        tnorms.row_geometry(y.shape, y.stride())


def test_the_wrapper_refuses_before_any_launch():
    """`_launch` checks the operands before it builds or calls the kernel,
    so these raise here, where there is neither a card nor nvcc."""
    kw = dict(eps=1e-6, rms=True, out_dtype=None)
    bad = {
        "does not collapse": torch.zeros((4, 6, 8, 16), dtype=torch.bfloat16)[::2, ::2, ::2],
        "C % 8": torch.zeros((4, 12), dtype=torch.bfloat16),
        "fp32 / bf16": torch.zeros((4, 16), dtype=torch.float16),
        "not multiples": torch.zeros((4, 20), dtype=torch.bfloat16)[:, :16],
    }
    for match, x in bad.items():
        with pytest.raises(ValueError, match=match):
            tnorms._launch(tnorms.rmsnorm, x, None, None, **kw)
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gamma and beta"):
        tnorms._launch(tnorms.layernorm, x, torch.ones(16), torch.ones(16, dtype=torch.bfloat16),
                       1e-6, False, None)
    assert tnorms.rmsnorm.launches == 0 and tnorms.layernorm.launches == 0


@pytest.mark.parametrize("c", [8, 64, 128, 256, 640, 1280, 2048, 2560, 3072, 3584, 3840, 4096,
                               8192])
def test_launch_config_meets_the_kernel_contract(c):
    """(threads a block, threads a row) as `lp_row_norm` takes them: whole
    warps, at most 1,024; threads a row a power of two up to 32 or a
    multiple of 32, dividing the block; every 16-byte vector of a row
    covered by at most 8 a thread; the register cap at that many."""
    threads, tpr = tnorms.launch_config(c)
    assert threads % 32 == 0 and 32 <= threads <= 1024 and threads % tpr == 0
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    nvec = c // tnorms.VEC
    nv = 1 << (-(-nvec // tpr) - 1).bit_length()
    assert nv <= 8 and threads <= tnorms.max_threads(nv)


@pytest.fixture
def recorded(monkeypatch):
    """Every row-norm call of a model forward: (name, shape, strides), each
    checked by `row_geometry` on the way (every model reaches the kernels
    through models/layers.py, Wan's full-width q / k norm too); a call with
    RoPE in the epilogue ("rmsnorm_rope") also records its table geometry
    (`rope_geometry`) as a fourth entry."""
    calls = []

    def wrap(name, plain):
        def record(x, *args, **kw):
            calls.append((name, tuple(x.shape), x.stride()))
            tnorms.row_geometry(x.shape, x.stride())
            return plain(x, *args, **kw)
        return record

    def record_rope(x, gamma, eps, freqs, head_dim):
        calls.append(("rmsnorm_rope", tuple(x.shape), x.stride(),
                      tnorms.rope_geometry(x.shape, freqs.shape, freqs.stride(), head_dim)))
        tnorms.row_geometry(x.shape, x.stride())
        return tnorms.rmsnorm_rope(x, gamma, eps, freqs, head_dim)

    monkeypatch.setattr(layers, "layernorm", wrap("layernorm", tnorms.layernorm))
    monkeypatch.setattr(layers, "rmsnorm", wrap("rmsnorm", tnorms.rmsnorm))
    monkeypatch.setattr(layers, "rmsnorm_rope", record_rope)
    return calls


def test_mmdit_norm_layouts(recorded):
    """A small MMDiT (hidden 256, 2 heads of 128, one double and one single
    block): QKNorm reads thirds of the double blocks' qkv and column slices
    of the single block's linear1, layernorm_na dense rows."""
    cfg = dataclasses.replace(dit.FLUX_DEV_CONFIG, hidden=256, num_heads=2, depth_double=1,
                              depth_single=1, context_dim=64, vec_dim=32)
    _, module = zoo.build_dit(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 16, 32, 32), generator=gen), torch.tensor([0.7]),
               torch.randn((1, 16, 64), generator=gen), torch.randn((1, 32), generator=gen),
               torch.tensor([3.5]))
    assert not [c for c in recorded if c[0] == "rmsnorm"]  # QKNorm takes RoPE in its epilogue
    rms = [c[1:] for c in recorded if c[0] == "rmsnorm_rope"]
    assert len(rms) == 4 + 2  # q, k of img and txt in the double block; q, k in the single
    # the table: (1, 16 + 256, 64, 2, 2), token stride 256 elements
    for (shape, stride, rope), n_tok in zip(rms[:4], (256, 256, 16, 16)):
        # double block: (1, S, 2, 128) thirds of (1, S, 768), img then txt,
        # each reading its stream's rows of the table (2 heads a token)
        assert shape[2:] == (2, 128) and stride[1:] == (768, 128, 1)
        assert tnorms.row_geometry(shape, stride) == (shape[1], 2, 768, 128)
        assert rope == (2, n_tok, 0, 256)
    for shape, stride, rope in rms[4:]:  # single block: linear1 is 3 * 256 + 4 * 256 wide
        assert shape == (1, 256 + 16, 2, 128) and stride[1] == 7 * 256
        assert tnorms.row_geometry(shape, stride) == (272, 2, 7 * 256, 128)
        assert rope == (2, 272, 0, 256)
    ln = [c[1:] for c in recorded if c[0] == "layernorm"]
    assert ln and all(tnorms.row_geometry(s, st)[0] == 1 for s, st in ln)  # dense rows


def test_wan_norm_layouts(recorded):
    """A small Wan DiT: the full-width q / k norms and layernorm_na / norm3
    read dense (B, S, hidden) rows."""
    cfg = dataclasses.replace(wan.TINY_WAN_CONFIG, hidden=256, num_heads=2, depth=1,
                              axes_dim=(44, 42, 42))
    _, module = zoo.build_wan(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 4, 1, 16, 16), generator=gen), torch.tensor([0.7]),
               torch.randn((1, 8, 32), generator=gen))
    names = [c[0] for c in recorded]
    assert names.count("rmsnorm") == 2  # cross q, k
    assert names.count("rmsnorm_rope") == 2  # self q, k, RoPE in the epilogue
    for _, shape, stride, *rope in recorded:
        assert tnorms.row_geometry(shape, stride) == (1, shape[0] * shape[1], 0, 256)
        # full-width rows, one token each: the table (1, 64, 64, 2, 2)
        assert rope in ([], [(1, 64, 0, 256)])


def test_unet_norm_layouts(recorded):
    """The UNet's transformer LayerNorms (SDXL's) read dense rows."""
    cfg = unet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                          transformer_depth=(1, 1), transformer_depth_middle=1,
                          context_dim=64, head_dim=64)
    _, module = zoo.build_unet(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 4, 16, 16), generator=gen), torch.tensor([500.0]),
               torch.randn((1, 8, 64), generator=gen))
    assert recorded and {c[0] for c in recorded} == {"layernorm"}
    for _, shape, stride in recorded:
        assert tnorms.row_geometry(shape, stride) == (1, shape[0] * shape[1], 0, shape[2])


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["qkv_third", "linear1_slice"])
def test_plain_norms_on_strided_views_match_jax_on_the_copy(layout, dtype):
    rng = np.random.default_rng(7)
    # q|k|v thirds (k: columns 128..) or a linear1-style slice (columns 256..)
    width, start = {"qkv_third": (3 * 4 * 32, 128), "linear1_slice": (7 * 4 * 32, 256)}[layout]
    full = torch.from_numpy(rng.standard_normal((2, 19, width)).astype(np.float32) * 2 + 0.5)
    x = full.to(dtype)[..., start:start + 4 * 32].unflatten(-1, (4, 32))
    assert not x.is_contiguous()
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(32).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(32).astype(np.float32))
    jx = jnp.asarray(x.float().contiguous().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jg, jb = jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy())
    _assert_close(tnorms.rmsnorm_ref(x, gamma), jnorms.fused_rmsnorm(jx, jg), dtype)
    _assert_close(tnorms.layernorm_ref(x, gamma, beta, eps=1e-6),
                  jnorms.fused_layernorm(jx, jg, jb, eps=1e-6), dtype)
    _assert_close(tnorms.layernorm_ref(x, eps=1e-6, out_dtype=torch.float32),
                  jnorms.fused_layernorm(jx, eps=1e-6, out_dtype=jnp.float32), torch.float32)
