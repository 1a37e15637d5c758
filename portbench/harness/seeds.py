"""Seeds derived from the run's `--seed`, any whole number."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for the draw named by `keys` (strings or ints)."""
    words = [int(seed) % 2**64 & 0xFFFFFFFF, (int(seed) % 2**64) >> 32]
    for k in keys:
        words.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k) % 2**32)
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).astype(np.uint64)
               .dot(np.array([1, 2**32], np.uint64)) & np.uint64(2**63 - 1))
