"""The fused think-step kernel's draw and launch geometry, on the CPU.

The kernel (`lanpaint_tpu_torch/csrc/fused.cu`) runs only on the card;
`chip_smoke.py` holds it there against the plain versions fed
`ops/fused.philox_normals`.  What the CPU can check is that twin and the
kernel's index arithmetic:

1. `philox4x32_10` against Random123's known-answer vectors for
   Philox4x32-10 (its kat_vectors file);
2. Box-Muller on all-zero bits gives (sqrt(-2 ln 2^-25), 0), the pair the
   JAX kernel's PRNG gives in interpret mode (tests/test_torch_fused.py);
3. the draw is a function of the flat index alone: a (2, M) view draws the
   flat (1, 2M) draw row by row;
4. streams, launches and batch rows are uncorrelated (|corr| < 0.01, about
   5 sigma at 2^18 elements) and each stream has mean 0 and std 1 within
   0.01 (5 and 7 sigma);
5. a Python emulation of the kernel's launch geometry (its grid, each
   row's quads, its thread -> quad map) covers every element exactly once,
   with the 16-byte path on every quad that lies in one row;
6. no source of the port names triton.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lanpaint_tpu_torch.ops import fused

REPO = Path(__file__).resolve().parent.parent
ONES = 0xFFFFFFFF
# (counter, key, output words): Random123's kat_vectors, philox4x32 with 10 rounds
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((ONES,) * 4, (ONES, ONES), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
R = math.sqrt(-2.0 * math.log(2.0**-25))


@pytest.mark.parametrize("counter, key, want", KNOWN_ANSWERS, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = fused.philox4x32_10(counter, key)
    assert [int(w) for w in got] == list(want)
    # vectorised over a batch of counters: each lane the scalar answer
    batch = fused.philox4x32_10(tuple(np.full(5, c, np.uint32) for c in counter), key)
    for w, v in zip(batch, want):
        assert w.dtype == np.uint32 and (w == v).all()


def test_zero_bits_map_to_radius_and_zero():
    n0, n1 = fused.box_muller(np.zeros(3, np.uint32), np.zeros(3, np.uint32))
    assert n0.dtype == np.float32 and n1.dtype == np.float32
    np.testing.assert_allclose(n0, np.float32(R), rtol=1e-7)
    assert (n1 == 0.0).all()
    # the largest words: u1 rounds to 1, a zero radius, not a NaN
    m0, m1 = fused.box_muller(np.full(1, ONES, np.uint32), np.full(1, ONES, np.uint32))
    assert np.isfinite(m0).all() and np.isfinite(m1).all()


@pytest.mark.parametrize("m", [1000, 999, 1001])
def test_row_draw_equals_flat_draw(m):
    rows = fused.philox_normals(1234, 7, 2, m)
    flat = fused.philox_normals(1234, 7, 1, 2 * m)
    assert rows.shape == (3, 2, m) and rows.dtype == torch.float32
    assert torch.equal(rows, flat.reshape(3, 2, m))


def test_draw_takes_a_seed_tensor_and_all_64_bits():
    seed = -(2**40) - 5  # a negative int64: both key words non-zero
    a = fused.philox_normals(torch.tensor([seed], dtype=torch.int64), 3, 1, 64)
    assert torch.equal(a, fused.philox_normals(seed, 3, 1, 64))
    # the high word enters the key: seeds 2^32 apart draw differently
    assert not torch.equal(fused.philox_normals(5, 0, 1, 64),
                           fused.philox_normals(5 + 2**32, 0, 1, 64))


def test_streams_launches_and_rows_are_independent_normals():
    b, m = 2, 1 << 17  # 2^18 elements
    d0 = fused.philox_normals(2024, 0, b, m).double()
    d1 = fused.philox_normals(2024, 1, b, m).double()

    def corr(p, q):
        return float(torch.corrcoef(torch.stack([p.flatten(), q.flatten()]))[0, 1])

    for j in range(3):
        s = d0[j]
        assert abs(float(s.mean())) < 0.01 and abs(float(s.std()) - 1.0) < 0.01, j
        assert abs(corr(d0[j], d1[j])) < 0.01, f"launches, stream {j}"
        assert abs(corr(d0[j][0], d0[j][1])) < 0.01, f"rows, stream {j}"
        for k in range(j):
            assert abs(corr(d0[j], d0[k])) < 0.01, f"streams {k}, {j}"
    # the tails: about 0.27% of a normal lies beyond 3 sigma
    assert 0.002 < float((d0.abs() > 3).double().mean()) < 0.0035


def _emulate(b, m, threads, quads):
    """Per element of the (b, m) view: how many threads store it, and
    whether by the 16-byte path (inputs 16-byte aligned), as csrc/fused.cu
    launches (lp_fused_think's grid: ceil(quads a row / (threads * quads))
    blocks a row, M / 4 quads a row or up to two more where rows start off a
    quad boundary) and maps block (bx, row), thread t and quad k to flat quad
    q_first + (bx * quads + k) * threads + t of the row's [q_first, q_end),
    keeping only the row's elements."""
    row_quads = m // 4 + 2 if m % 4 else m // 4
    gx = -(-row_quads // (threads * quads))
    count = np.zeros(b * m, np.int64)
    vector = np.zeros(b * m, bool)
    t = np.arange(threads)
    for row in range(b):
        lo, hi = row * m, row * m + m
        q_first, q_end = lo >> 2, (hi + 3) >> 2
        assert q_end - q_first <= row_quads
        for bx in range(gx):
            for k in range(quads):
                q = q_first + (bx * quads + k) * threads + t
                e = 4 * q[q < q_end]
                full = (e >= lo) & (e + 4 <= hi)
                for lane in range(4):
                    el = e + lane
                    inside = (el >= lo) & (el < hi)
                    np.add.at(count, el[inside], 1)
                    vector[el[full]] = True
    return count, vector


@pytest.mark.parametrize("config", [(128, 1), (128, 2), (256, 1), (256, 2)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("b, m", [(1, 16 * 128 * 128), (1, 4 * 128 * 128), (2, 999), (3, 1001),
                                  (2, 1000)], ids=["flux", "sdxl", "2x999", "3x1001", "2x1000"])
def test_launch_geometry_covers_every_element_once(b, m, config):
    count, vector = _emulate(b, m, *config)
    assert (count == 1).all(), f"elements stored {set(count.tolist())} times"
    e = np.arange(b * m)
    offset = e % m  # place within the row
    if m % 4 == 0:
        assert vector.all()
    else:  # only a quad that straddles two rows takes the scalar path
        scalar = ~vector
        assert scalar.any()
        assert ((offset[scalar] < 3) | (offset[scalar] >= m - 3)).all()


def test_block_shape_is_one_the_kernel_takes():
    threads, quads = fused.BLOCK_SHAPE  # lp_fused_think refuses any other
    assert 64 <= threads <= 256 and threads % 32 == 0 and quads in (1, 2)


def test_port_names_no_triton():
    sources = sorted((REPO / "lanpaint_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", *sorted((REPO / "scripts").glob("measure_torch_*.py"))]
    for path in sources:
        if "_build" in path.parts:
            continue
        for no, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0].strip()
            bad = code.startswith(("import triton", "from triton", "@triton"))
            assert not bad, f"{path.relative_to(REPO)}:{no}: {line.strip()}"
