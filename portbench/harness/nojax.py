"""The check that the process never loaded JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lanpaint_tpu"})


def loaded(modules=None) -> list:
    """Names in `modules` (sys.modules) whose top-level name, the part
    before the first dot, is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)
