"""The plain versions beside the port's two Hopper kernels, on the CPU.

`attention_ref` against `lanpaint_tpu.models.layers.attention_bshd` and
`layernorm_ref` / `rmsnorm_ref` against `lanpaint_tpu.ops.norms`.  On the
CPU the JAX functions take their own plain references (XLA attention, the
jnp row norm), as the JAX package's tests run them.  The port's wrappers
take the plain version for a CPU tensor and do not count a launch; on any
other non-CUDA device they raise.  `models.layers.attention_bshd` routes
by shape, cross-attention (Sk != S) included.  The kernels themselves run only on the
card; `chip_smoke.py` compares them with these plain versions there.

Tolerances: fp32 1e-5.  bf16 one ulp: for the row norms one ulp of each
element (both sides round the same fp32 math once), for attention one ulp
at the output's largest magnitude (JAX rounds the softmax to bf16 before
P @ V, the port keeps it in fp32, so small outputs differ by more than
their own ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanpaint_tpu.models.layers import attention_bshd
from lanpaint_tpu.ops import norms as jnorms
from lanpaint_tpu_torch.ops import attention as tattn
from lanpaint_tpu_torch.ops import norms as tnorms

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_ulp(a):
    """Spacing of bf16 numbers (8 significant bits) at magnitude |a|."""
    mag = np.maximum(np.abs(np.asarray(a, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _pair(rng, shape, dtype, scale=1.0, shift=0.0):
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,s,sk,h,d", [(2, 64, 64, 4, 16), (1, 100, 100, 3, 16),
                                        (1, 64, 64, 2, 64), (2, 100, 100, 3, 64),
                                        (2, 64, 77, 4, 64)],
                         ids=["s64_d16", "s100_d16", "s64_d64", "s100_d64", "cross_sk77"])
def test_attention_ref_matches_jax(b, s, sk, h, d, dtype):
    rng = np.random.default_rng(s * 1000 + d)
    jq, tq = _pair(rng, (b, s, h, d), dtype)
    jk, tk = _pair(rng, (b, sk, h, d), dtype)
    jv, tv = _pair(rng, (b, sk, h, d), dtype)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(attention_bshd(jq, jk, jv), np.float32)
    got = tattn.attention_ref(tq, tk, tv)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(np.abs(want).max()))


def test_attention_ref_scale_argument():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 2, 16)).astype(np.float32))
               for _ in range(3))
    np.testing.assert_allclose(tattn.attention_ref(q, k, v, scale=0.25).numpy(),
                               tattn.attention_ref(q * 0.25 * 4.0, k, v).numpy(),
                               rtol=1e-6, atol=1e-6)


def _assert_norm_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 ulp of each element, above the fp32 rounding of x - mean
        err = np.abs(got - want)
        assert np.all(err <= _bf16_ulp(want) + 1e-6), float((err / _bf16_ulp(want)).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp32_out"])
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_layernorm_ref_matches_jax(dtype, affine):
    rng = np.random.default_rng(4)
    in_dtype = "bf16" if dtype == "fp32_out" else dtype
    jx, tx = _pair(rng, (3, 50, 640), in_dtype, scale=2.0, shift=0.7)
    jg, tg = _pair(rng, (640,), "fp32", scale=0.3, shift=1.0)
    jb, tb = _pair(rng, (640,), "fp32", scale=0.3)
    out_dtype = (jnp.float32, torch.float32) if dtype == "fp32_out" else (None, None)
    args_j = (jg, jb) if affine else (None, None)
    args_t = (tg, tb) if affine else (None, None)
    want = jnorms.layernorm_ref(jx, *args_j, eps=1e-6, out_dtype=out_dtype[0])
    got = tnorms.layernorm_ref(tx, *args_t, eps=1e-6, out_dtype=out_dtype[1])
    assert got.dtype == (torch.float32 if dtype == "fp32_out" else tx.dtype)
    _assert_norm_close(got, want, "fp32" if dtype == "fp32_out" else dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_rmsnorm_ref_matches_jax(dtype, affine):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (4, 33, 128), dtype, scale=1.5, shift=0.2)
    jg, tg = _pair(rng, (128,), "fp32", scale=0.3, shift=1.0)
    want = jnorms.rmsnorm_ref(jx, jg if affine else None, eps=1e-6)
    got = tnorms.rmsnorm_ref(tx, tg if affine else None, eps=1e-6)
    assert got.dtype == tx.dtype
    _assert_norm_close(got, want, dtype)


def test_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    rng = np.random.default_rng(6)
    launches = (tattn.flash_attention.launches, tnorms.layernorm.launches,
                tnorms.rmsnorm.launches)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 64)).astype(np.float32))
               .bfloat16() for _ in range(3))
    assert torch.equal(tattn.flash_attention(q, k, v), tattn.attention_ref(q, k, v))
    x = torch.from_numpy(rng.standard_normal((6, 640)).astype(np.float32)).bfloat16()
    g, b = torch.ones(640), torch.zeros(640)
    assert torch.equal(tnorms.layernorm(x, g, b, eps=1e-6),
                       tnorms.layernorm_ref(x, g, b, eps=1e-6))
    assert torch.equal(tnorms.layernorm(x, eps=1e-6, out_dtype=torch.float32),
                       tnorms.layernorm_ref(x, eps=1e-6, out_dtype=torch.float32))
    assert torch.equal(tnorms.rmsnorm(x, g), tnorms.rmsnorm_ref(x, g))
    assert (tattn.flash_attention.launches, tnorms.layernorm.launches,
            tnorms.rmsnorm.launches) == launches == (0, 0, 0)


def test_cross_attention_on_cpu_takes_the_plain_path_and_counts_nothing():
    """`flash_attention` with Sk != S on a CPU tensor is `attention_ref`,
    and neither `.launches` nor `.cross_launches` moves; the summary
    reports the cross counter under its own key, outside `launches()`,
    whose keys `families` folds into the card's kernel families."""
    from lanpaint_tpu_torch import telemetry

    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 40, 2, 64)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, 77, 2, 64)).astype(np.float32)).bfloat16()
            for _ in range(2))
    before = (tattn.flash_attention.launches, tattn.flash_attention.cross_launches)
    assert torch.equal(tattn.flash_attention(q, k, v), tattn.attention_ref(q, k, v))
    assert (tattn.flash_attention.launches, tattn.flash_attention.cross_launches) == before
    summary = telemetry.summary()
    assert summary["cross_launches"] == tattn.flash_attention.cross_launches
    assert not any("cross" in name for name in telemetry.launches())


# (S, Sk, D) -> the wrapper attention_bshd takes, as the JAX package routes
# by shape (its "auto": a kernel from S = 1,024 at D % 64 == 0)
ROUTES = {
    "wan_cross": ((1024, 77, 128), "flash_attention"),
    "wan_cross_d64": ((1024, 512, 64), "flash_attention"),
    "self": ((1024, 1024, 64), "flash_attention"),
    "short_cross": ((1000, 77, 128), "attention_ref"),
    "short_self": ((1000, 1000, 64), "attention_ref"),
    "cross_head_dim_96": ((1024, 77, 96), "attention_ref"),
    "wide_self": ((1024, 1024, 640), "wide_attention"),
    "wide_cross": ((1024, 77, 640), "attention_ref"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_attention_bshd_routes_by_shape(name, monkeypatch):
    """`models.layers.attention_bshd`: S >= 1,024 queries at D % 64 == 0
    reach `flash_attention` whatever Sk (Wan's cross-attention over its text
    tokens), `wide_attention` for self-attention at a wide head; a wide
    head's cross-attention and anything shorter stay `attention_ref`."""
    from lanpaint_tpu_torch.models import layers

    (s, sk, d), want = ROUTES[name]
    seen = []
    for wrapper in ("flash_attention", "wide_attention", "attention_ref"):
        def spy(q, k, v, scale=None, _name=wrapper):
            seen.append(_name)
            return tattn.attention_ref(q, k, v, scale)
        monkeypatch.setattr(layers, wrapper, spy)
    q = torch.zeros((1, s, 1, d), dtype=torch.bfloat16)
    kv = torch.zeros((1, sk, 1, d), dtype=torch.bfloat16)
    out = layers.attention_bshd(q, kv, kv)
    assert seen == [want] and tuple(out.shape) == (1, s, 1, d)


def test_wrappers_raise_off_cpu_without_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not sent to the plain version."""
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_attention(q, q, q)
    x = torch.empty((4, 640), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tnorms.layernorm(x)
    with pytest.raises(ValueError, match="unsupported device"):
        tnorms.rmsnorm(x)
