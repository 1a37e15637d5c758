"""The TMA tensor-map geometry of the D <= 128 attention kernel, on the CPU.

`ops.attention.tma_geometry` computes, from an operand's shape, strides
and data pointer alone, the 4D tensor map that `csrc/attention.cu` encodes
(dims (D, H, S, B), byte strides, a (64, 1, rows, 1) box), and refuses a
layout TMA cannot take.  The kernel itself runs only on the card
(`chip_smoke.py` checks it there); these tests hold the geometry to every
layout the port's callers hand the kernel:

* at full size (meta tensors: real strides and offsets, no memory): the
  SDXL UNet's fused-qkv split views, Flux's single-block v (a column slice
  of `linear1`'s output, row stride 21,504), the contiguous RoPE outputs
  of Flux's double blocks and of Wan (S = 7,920, ragged at 64 and 128
  rows), and B = 2 with S = 1,000;
* by emulating a TMA box load from the geometry over a tensor's storage
  (out-of-bounds elements zero, as TMA's fill) against the tensor indexed
  directly, at small sizes of each layout;
* through the callers themselves: small bf16 UNet, MMDiT and Wan models on
  the CPU, whose every `flash_attention` call is recorded.
"""

import dataclasses

import pytest
import torch

from lanpaint_tpu_torch.models import dit, layers, unet, wan, zoo
from lanpaint_tpu_torch.ops import attention as tattn


def _split_views(b, s, h, d, width=None, device="meta"):
    """q, k, v as the UNet / DiT hand them over: unflattened thirds of one
    (B, S, width) projection (width 3 * H * D, or Flux's single-block
    `linear1` width with q|k|v first)."""
    fused = torch.empty((b, s, width or 3 * h * d), dtype=torch.bfloat16, device=device)
    return [t.unflatten(-1, (h, d)) for t in fused[..., :3 * h * d].chunk(3, dim=-1)]


def _contiguous(b, s, h, d, device="meta"):
    return [torch.empty((b, s, h, d), dtype=torch.bfloat16, device=device) for _ in range(3)]


FLUX_LINEAR1 = 3 * 3072 + 4 * 3072  # q|k|v and the MLP input of a Flux single block
LAYOUTS = {  # name: (q, k, v) at a main path's full size
    "sdxl_split_s4096": lambda: _split_views(1, 4096, 10, 64),
    "sdxl_split_s1024": lambda: _split_views(1, 1024, 20, 64),
    "flux_single_block": lambda: _split_views(1, 4608, 24, 128, width=FLUX_LINEAR1),
    "flux_double_rope": lambda: _contiguous(1, 4608, 24, 128),
    "wan_rope_s7920": lambda: _contiguous(1, 7920, 24, 128),
    "ragged_b2_d64": lambda: _split_views(2, 1000, 4, 64),
    "ragged_b2_d128": lambda: _contiguous(2, 1000, 4, 128),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_geometry_of_caller_layouts(name):
    q, k, v = LAYOUTS[name]()
    b, s, h, d = q.shape
    for t, rows in ((q, tattn.BLOCK_M), (k, tattn.BLOCK_N), (v, tattn.BLOCK_N)):
        dims, strides, box = tattn.tma_geometry(t.shape, t.stride(), t.data_ptr(), rows)
        assert dims == (d, h, s, b)
        assert strides[0] == 2 * t.stride(2) and strides[1] == 2 * t.stride(1)
        assert strides[2] == (2 * t.stride(0) if b > 1 else strides[1] * s)
        assert box == (tattn.BOX_COLS, 1, rows, 1)
    geom = list(tattn._tma_geometries(q, k, v))
    assert len(geom) == 33 and geom[:4] == [d, h, s, b]
    if name == "flux_single_block":  # v read in place: row stride 21,504 elements
        assert geom[22 + 5] == 2 * 21504 and v.data_ptr() - q.data_ptr() == 2 * 2 * 3072
    if name == "wan_rope_s7920":  # ragged at both tile heights: the last K/V tile holds 112 keys
        assert (s % tattn.BLOCK_M, s % tattn.BLOCK_N, s % 64) == (112, 112, 48)
    if name.startswith("sdxl"):  # k and v 1,280 / 2,560 bytes into each row
        assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (2 * h * d,
                                                                             4 * h * d)


def _tma_box(t, geometry, c0, h, s0, b):
    """The box a TMA load at coordinates (c0, h, s0, b) would copy: the
    storage read through the geometry's byte strides, elements outside the
    dims zero."""
    (dd, hh, ss, bb), strides, (cols, _, rows, _) = geometry
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    es = [st // t.element_size() for st in strides]
    out = torch.zeros((rows, cols), dtype=t.dtype)
    for r in range(rows):
        for c in range(cols):
            if c0 + c < dd and s0 + r < ss and h < hh and b < bb:
                out[r, c] = flat[t.storage_offset() + c0 + c + h * es[0] + (s0 + r) * es[1]
                                 + b * es[2]]
    return out


@pytest.mark.parametrize("layout", ["split", "linear1", "contiguous"])
@pytest.mark.parametrize("d", [64, 128])
def test_emulated_tma_box_reads_the_tensor(layout, d):
    """A box of each operand, read through the geometry from the storage
    as TMA would, equals the tensor's own (rows, 64) block, with the rows
    past S zero: the ragged last block of a B = 2, S = 150 problem."""
    b, s, h = 2, 150, 3
    gen = torch.Generator().manual_seed(d)
    make = {"split": lambda: _split_views(b, s, h, d, device="cpu"),
            "linear1": lambda: _split_views(b, s, h, d, width=7 * h * d, device="cpu"),
            "contiguous": lambda: _contiguous(b, s, h, d, device="cpu")}[layout]
    q, k, v = make()
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    for t, rows in ((q, tattn.BLOCK_M), (v, tattn.BLOCK_N)):
        geometry = tattn.tma_geometry(t.shape, t.stride(), t.data_ptr(), rows)
        for c0, hi, s0, bi in ((0, 0, 0, 0), (d - 64, 2, 128, 1)):
            want = torch.zeros((rows, 64), dtype=t.dtype)
            part = t[bi, s0:s0 + rows, hi, c0:c0 + 64]
            want[:part.shape[0]] = part
            assert torch.equal(_tma_box(t, geometry, c0, hi, s0, bi), want)


def test_geometry_refuses_what_tma_cannot_take():
    # a view 2 bytes off a 16-byte boundary
    base = torch.zeros(1 + 64 * 2 * 64, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 64, 2, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.tma_geometry(shifted.shape, shifted.stride(), shifted.data_ptr(), 128)
    # a row stride of 68 elements (136 bytes), not a multiple of 8 elements
    padded = torch.zeros((1, 64, 1, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tattn.tma_geometry(padded.shape, padded.stride(), padded.data_ptr(), 128)
    # a head dim the kernel does not take, and a strided head dim
    with pytest.raises(ValueError, match="head dim 96"):
        tattn.tma_geometry((1, 64, 2, 96), (12288, 192, 96, 1), 0, 128)
    with pytest.raises(ValueError, match="unit stride"):
        tattn.tma_geometry((1, 64, 2, 64), (16384, 256, 128, 2), 0, 128)
    # the whole-call check refuses through the same function
    q, k, v = _split_views(1, 64, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tattn._tma_geometries(q, k, padded)


def test_a_dim_of_extent_one_takes_the_packed_stride():
    """B = 1 and H = 1 are never stepped, so any stride torch reports for
    them is accepted and replaced by the packed one."""
    dims, strides, _ = tattn.tma_geometry((1, 100, 1, 64), (3, 64, 5, 1), 0, 128)
    assert dims == (64, 1, 100, 1) and strides == (128, 128, 12800)


@pytest.fixture
def recorded(monkeypatch):
    """Every flash_attention call of a model forward, its operands checked
    by `tma_geometry` on the way."""
    calls = []
    plain = layers.flash_attention

    def record(q, k, v, scale=None):
        calls.append([(t.shape, t.stride(), t.storage_offset()) for t in (q, k, v)])
        tattn._tma_geometries(q, k, v)
        return plain(q, k, v, scale)

    monkeypatch.setattr(layers, "flash_attention", record)
    return calls


def test_unet_self_attention_layouts(recorded):
    """The UNet's self-attention (CrossAttention with fused qkv) at head dim
    64 on a 64 x 64 latent (S = 1,024 and up, where the kernel takes it):
    S = 4,096 and 1,024 (the middle block's too), strided split views."""
    cfg = unet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                          transformer_depth=(1, 1), transformer_depth_middle=1,
                          context_dim=64, head_dim=64)
    _, module = zoo.build_unet(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 4, 64, 64), generator=gen), torch.tensor([500.0]),
               torch.randn((1, 8, 64), generator=gen))
    seqs = sorted({c[0][0][1] for c in recorded})
    assert seqs == [1024, 4096]
    for (shape, stride, _), _, _ in recorded:
        assert shape[-1] == 64 and stride[1] == 3 * shape[2] * 64  # fused qkv rows


def test_mmdit_joint_attention_layouts(recorded):
    """A small MMDiT at head dim 128 (hidden 256, 2 heads) on a 64 x 64
    latent: 1,024 image + 16 text tokens; double blocks hand contiguous
    RoPE outputs, single blocks a v sliced from `linear1`'s output."""
    cfg = dataclasses.replace(dit.FLUX_DEV_CONFIG, hidden=256, num_heads=2, depth_double=1,
                              depth_single=1, context_dim=64, vec_dim=32)
    _, module = zoo.build_dit(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 16, 64, 64), generator=gen), torch.tensor([0.7]),
               torch.randn((1, 16, 64), generator=gen), torch.randn((1, 32), generator=gen),
               torch.tensor([3.5]))
    assert len(recorded) == 2
    (q2, _, v2), (q1, _, v1) = recorded
    assert q2[0] == (1, 1040, 2, 128) and q2[1] == (1040 * 256, 256, 128, 1)
    assert v1[1][1] == 3 * 256 + 4 * 256  # the single block's v: a column slice of linear1
    assert v1[2] == 2 * 256  # ... 512 elements into each row


def test_wan_self_attention_layouts(recorded):
    """A small Wan DiT at head dim 128 on a (1, 4, 1, 64, 64) latent: S =
    1,024 patches, contiguous RoPE q and k, v a dense projection's view."""
    cfg = dataclasses.replace(wan.TINY_WAN_CONFIG, hidden=256, num_heads=2, depth=1,
                              axes_dim=(44, 42, 42))
    _, module = zoo.build_wan(cfg, device="cpu", param_dtype=torch.bfloat16, seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        module(torch.randn((1, 4, 1, 64, 64), generator=gen), torch.tensor([0.7]),
               torch.randn((1, 8, 32), generator=gen))
    assert len(recorded) == 1
    for shape, stride, _ in recorded[0]:
        assert shape == (1, 1024, 2, 128) and stride == (1024 * 256, 256, 128, 1)


# ---- the wide-head kernel (csrc/wide_attention.cu): D = 384 / 512 / 640 ----

def _vae_views(b, s, d, device="meta"):
    """The VAEs' mid-attention operands at one head: the video VAE's
    (B*T, S, 1, 3D) `to_qkv` output split three ways, or the image VAE's
    three dense projections viewed as (B, S, 1, D)."""
    if d in (384, 640):
        qkv = torch.empty((b, s, 1, 3 * d), dtype=torch.bfloat16, device=device)
        return list(qkv.chunk(3, dim=-1))
    return [torch.empty((b, s, d), dtype=torch.bfloat16, device=device).view(b, s, 1, d)
            for _ in range(3)]


WIDE_LAYOUTS = {  # name: (q, k, v) at a main path's full size
    "wan22_vae_d640": lambda: _vae_views(9, 3520, 640),   # 704x1280 x 33 frames
    "wan21_vae_d384": lambda: _vae_views(9, 6240, 384),   # 480x832 x 33 frames
    "sdxl_vae_d512": lambda: _vae_views(1, 16384, 512),   # 1024^2
    "sdxl_vae_d512_s4096": lambda: _vae_views(1, 4096, 512),
}


@pytest.mark.parametrize("name", list(WIDE_LAYOUTS))
def test_wide_geometry_of_vae_layouts(name):
    """Dims (D, 1, S, B) with the head's extent-1 stride taken as packed, a
    D-wide row read in D / 64 boxes of 128 bytes, 64-row boxes for q and
    32-row boxes for k and v; the column slices of `to_qkv` start 2D and 4D
    bytes into each row, both 16-byte aligned."""
    q, k, v = WIDE_LAYOUTS[name]()
    b, s, h, d = q.shape
    assert h == 1 and d // tattn.BOX_COLS == {384: 6, 512: 8, 640: 10}[d]
    for t, rows in ((q, tattn.WIDE_BLOCK_M), (k, tattn.WIDE_BLOCK_N), (v, tattn.WIDE_BLOCK_N)):
        dims, strides, box = tattn.tma_geometry(t.shape, t.stride(), t.data_ptr(), rows,
                                                tattn.WIDE_HEAD_DIMS)
        assert dims == (d, 1, s, b) and box == (tattn.BOX_COLS, 1, rows, 1)
        assert strides[0] == 2 * d  # H = 1: the packed stride, whatever torch reports
        assert strides[1] == 2 * t.stride(1) and strides[2] == 2 * t.stride(0)
    fused = d in (384, 640)
    assert q.stride(1) == (3 * d if fused else d)
    if fused:
        assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (2 * d, 4 * d)
        assert all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    geom = list(tattn._tma_geometries(q, k, v, tattn.WIDE_HEAD_DIMS, tattn.WIDE_BLOCK_M,
                                      tattn.WIDE_BLOCK_N))
    assert len(geom) == 33 and geom[:4] == [d, 1, s, b]
    assert [geom[9], geom[11 + 9], geom[22 + 9]] == [64, 32, 32]


def test_each_kernel_refuses_the_others_head_dims():
    with pytest.raises(ValueError, match="head dim 640"):
        tattn.tma_geometry((1, 64, 1, 640), (64 * 640, 640, 640, 1), 0, 128)
    with pytest.raises(ValueError, match="head dim 128"):
        tattn.tma_geometry((1, 64, 1, 128), (64 * 128, 128, 128, 1), 0, tattn.WIDE_BLOCK_M,
                           tattn.WIDE_HEAD_DIMS)


@pytest.mark.parametrize("d", [384, 512, 640])
def test_emulated_wide_tma_box_reads_the_tensor(d):
    """A box of each operand of the wide kernel, read through the geometry
    as TMA would, equals the tensor's own (rows, 64) block with the rows
    past S zero: the first box and the last box of a row, in the ragged last
    query tile of a B = 2, S = 100 problem."""
    b, s = 2, 100
    gen = torch.Generator().manual_seed(d)
    q, k, v = _vae_views(b, s, d, device="cpu")
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    for t, rows in ((q, tattn.WIDE_BLOCK_M), (v, tattn.WIDE_BLOCK_N)):
        geometry = tattn.tma_geometry(t.shape, t.stride(), t.data_ptr(), rows,
                                      tattn.WIDE_HEAD_DIMS)
        for c0, s0, bi in ((0, 0, 0), (d - 64, 64 if rows == 64 else 96, 1)):
            want = torch.zeros((rows, 64), dtype=t.dtype)
            part = t[bi, s0:s0 + rows, 0, c0:c0 + 64]
            want[:part.shape[0]] = part
            assert torch.equal(_tma_box(t, geometry, c0, 0, s0, bi), want)


@pytest.fixture
def recorded_wide(monkeypatch):
    """Every wide_attention call of a forward, its operands checked by the
    wide kernel's geometry on the way."""
    calls = []
    plain = layers.wide_attention

    def record(q, k, v, scale=None):
        calls.append([(t.shape, t.stride(), t.storage_offset()) for t in (q, k, v)])
        tattn._tma_geometries(q, k, v, tattn.WIDE_HEAD_DIMS, tattn.WIDE_BLOCK_M,
                              tattn.WIDE_BLOCK_N)
        return plain(q, k, v, scale)

    monkeypatch.setattr(layers, "wide_attention", record)
    return calls


def test_vae_mid_attention_layouts(recorded_wide):
    """The image VAE's mid attention (D = 512) and the video VAE's (D = 640,
    two frames) on 32 x 32 grids (S = 1,024): dense views, and column slices
    of one fused projection with row stride 3D."""
    from lanpaint_tpu_torch.models import vae, video_vae
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        vae.VAEAttnBlock(512)(torch.randn((1, 512, 32, 32), generator=gen))
        video_vae.WanVAEAttnBlock(640)(torch.randn((1, 2, 32, 32, 640), generator=gen))
    assert len(recorded_wide) == 2
    (q5, _, _), (q6, k6, v6) = recorded_wide
    assert q5[0] == (1, 1024, 1, 512) and q5[1][1] == 512
    assert q6[0] == (2, 1024, 1, 640) and q6[1][:2] == (1024 * 1920, 1920)
    assert (k6[2] - q6[2], v6[2] - q6[2]) == (640, 1280)  # element offsets of k and v
