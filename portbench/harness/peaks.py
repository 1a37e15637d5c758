"""One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense, at
700 W) and the least time a call could take on it."""

from __future__ import annotations

PEAK_BF16 = 989e12    # tensor-core FLOP/s, bf16
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def attention_ops(b, h, sq, sk, d) -> float:
    """4 B H Sq Sk D: the two products of softmax(q k^T) v."""
    return 4.0 * b * h * sq * sk * d


def attention_bytes(b, h, sq, sk, d, elem: int = 2) -> float:
    """q and the output read and written once, k and v read once, bf16."""
    return float(elem * b * h * d * (2 * sq + 2 * sk))


def bound_s(ops: float, n_bytes: float, peak: float = PEAK_BF16) -> float:
    """The larger of the operations over the peak rate and the bytes over
    the memory rate."""
    return max(ops / peak, n_bytes / PEAK_BYTES)


def attention_bound_s(calls) -> float:
    """The least time of a list of (B, H, Sq, Sk, D, count) calls."""
    return sum(n * bound_s(attention_ops(b, h, sq, sk, d), attention_bytes(b, h, sq, sk, d))
               for b, h, sq, sk, d, n in calls)
