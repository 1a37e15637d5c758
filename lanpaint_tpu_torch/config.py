"""Typed configuration for the LanPaint sampler.

One frozen (hashable, jit-static) dataclass replaces the reference's three
config mechanisms — node INPUT_TYPES schemas, ad-hoc `ModelPatcher.LanPaint_*`
attributes, and `model_options` dict keys (reference src/LanPaint/nodes.py:
300-318, 329-340; src/LanPaint/earlystop.py:74-95).

Defaults reproduce the reference node defaults exactly
(nodes.py:329-336, 367-377).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class ModelKind(enum.Enum):
    """Schedule family of the backbone (reference nodes.py:150-166).

    EPS: variance-exploding k-diffusion sigma space (SD1.5/SDXL, incl.
         v-prediction models — the prediction type is handled by the model
         wrapper, the *schedule* is still sigma-based).
    FLOW: rectified-flow / flow-matching t space (Flux, Z-Image, Qwen, SD3.5,
          HiDream, Wan2.2).  FLUX additionally forces cfg_big = 1.0 at the
          API layer (nodes.py:217-218).
    """

    EPS = "eps"
    FLOW = "flow"


@dataclasses.dataclass(frozen=True)
class LanPaintConfig:
    """Hyperparameters of the inner Langevin "think" loop.

    Reference surface (SURVEY.md section 2 hyperparameter table):
    NumSteps/Lambda/StepSize/Beta/Friction/EarlyStop/InnerThreshold/
    InnerPatience, plus PromptMode which lives at the guidance layer
    (`cfg_big`).
    """

    n_steps: int = 5            # LanPaint_NumSteps (0-100)
    lamb: float = 16.0          # LanPaint_Lambda (0.1-50)
    step_size: float = 0.2      # LanPaint_StepSize (0.0001-1)
    beta: float = 1.0           # LanPaint_Beta (0.0001-5)
    friction: float = 15.0      # LanPaint_Friction (0-50)
    outer_early_stop: int = 1   # LanPaint_EarlyStop: skip think loop in the
                                # last N sigma steps (nodes.py:177-183)
    inner_threshold: float = 0.0  # LanPaint_InnerThreshold; 0 disables
    inner_patience: int = 1       # LanPaint_InnerPatience (>=1)
    # Legacy 'min_steps' (reference earlystop.py:88-95): folded into a
    # patience floor, not an independent knob.
    inner_min_steps: int = 0
    # Optional custom semantic-stop distance: fn(prev_x_t, cur_x_t, ctx) ->
    # scalar (traced).  Static at trace time (reference's pluggable
    # `distance_fn`, earlystop.py:188-236; we support the canonical 3-arg
    # form only — jit cannot introspect signatures).
    distance_fn: Optional[Callable] = None
    # Record a per-inner-step trace buffer (device-side equivalent of
    # model_options["lanpaint_semantic_trace"], earlystop.py:315-334).
    record_trace: bool = False
    # Fused think-step kernels for the pointwise Langevin update
    # (ops/fused.py): two Triton launches per iteration on a CUDA latent,
    # with in-kernel normals; on the CPU their plain versions, fed the
    # unfused path's draws.  Off by default, as in the JAX package.
    use_fused_kernels: bool = False

    def __post_init__(self):
        if self.n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        if self.inner_patience < 1:
            raise ValueError("inner_patience must be >= 1")
        if not (self.step_size > 0):
            raise ValueError("step_size must be > 0")
        if not (self.beta > 0):
            raise ValueError("beta must be > 0")

    @property
    def patience_eff(self) -> int:
        """Effective consecutive-stable-step count: patience + 1.

        Matches earlystop.py:97-101 ("patience=1 stops after 2 stable
        steps"); legacy min_steps acts as a patience floor
        (earlystop.py:88-95).
        """
        patience = max(1, self.inner_patience)
        if self.inner_min_steps > 1:
            patience = max(patience, self.inner_min_steps - 1)
        return patience + 1

    @property
    def semantic_stop_possible(self) -> bool:
        """Static part of the early-stop enable predicate."""
        return self.inner_threshold > 0.0 and self.inner_patience > 0
