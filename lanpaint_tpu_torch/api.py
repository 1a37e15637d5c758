"""User-facing sampling API.

PyTorch counterpart of `lanpaint_tpu/api.py`, the equivalents of the
reference's exported nodes (reference src/LanPaint/nodes.py:631-638):

* `ksampler`               <-> LanPaint_KSampler (fixed defaults, nodes.py:298-349)
* `ksampler_advanced`      <-> LanPaint_KSamplerAdvanced (nodes.py:350-413)
* `sample_custom`          <-> LanPaint_SamplerCustom (nodes.py:491-556)
* `sample_custom_advanced` <-> LanPaint_SamplerCustomAdvanced (nodes.py:558-626)
* `masks.mask_blend`       <-> LanPaint_MaskBlend

and the pixel-space workflows `inpaint_image` (VAEEncode -> LanPaint_KSampler
-> VAEDecode -> LanPaint_MaskBlend), `outpaint_image`, `edit_image` (the
same graph with Qwen-Image-Edit's reference latents) and `inpaint_video`
(the same graph for video, through the Wan VAE).

The JAX package compiles a run into one XLA program; here it is an eager
loop on `latent`'s device: prep (initial noise, noise scaling, mask to the
latent grid), the run-constant conditioning `precompute` once per call, the
outer solver loop with the per-step think loop and CFG double pass (or,
without a mask, the plain CFG denoise), and the terminal inverse noise
scaling.

Every solver of the JAX package runs here (`samplers.SAMPLER_NAMES`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import samplers, telemetry
from .config import LanPaintConfig, ModelKind
from .engine import BatchRows, ThinkAux, lanpaint_update, randn
from .guidance import make_cfg_double_denoiser, resolve_cfg_big
from .masks import mask_blend, prepare_mask
from .models.base import Denoiser
from .schedule import inverse_noise_scaling, noise_scaling, unify_times
from .sigmas import apply_denoise, calculate_sigmas


def _max_denoise(sigmas, sigma_table) -> bool:
    if sigma_table is None:
        return True
    s0 = float(sigmas[0])
    mx = float(sigma_table.sigma_max)
    return math.isclose(s0, mx, rel_tol=1e-5) or s0 > mx


def _seed32(seed) -> int:
    """The seed folded to its low 32 bits, as the JAX package's `_seed_arg`
    does (so `seed + 1` for the decoupled think noise wraps at 2**32)."""
    return int(seed) & 0xFFFFFFFF


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree, device=device)


class LanPaintSampler:
    """A LanPaint sampling run for one (model, config, solver).

    Hyperparameters are constructor arguments; latents, masks,
    conditioning and seeds are call arguments.  The run happens on the
    device of `latent`; conditioning is moved there.

    `denoise_mask_fn(sigma, mask) -> mask` reshapes the latent-grid mask per
    outer step (`sigma` a 0-dim fp32 tensor on the latent's device).  A
    model of several experts (`Denoiser.route`, zoo.switching_denoiser) is
    routed per model call from the host sigma.
    `callback(i, denoised, x)` fires after each outer step with the global
    step index.  With `return_aux` a call returns (samples, denoised, aux),
    aux an `engine.ThinkAux` stacked over the outer steps (`steps_done` (N,)
    int32, `trace` (N, n_max, 8)), None on the mask-less path; pair it with
    `LanPaintConfig(record_trace=True)` to fill the trace rows when the
    semantic stop is off.
    """

    def __init__(
        self,
        model: Denoiser,
        *,
        config: LanPaintConfig = LanPaintConfig(),
        sampler_name: str = "euler",
        cfg: float = 5.0,
        cfg_big: Optional[float] = None,
        prompt_mode: str = "Image First",
        disable_cfg1_optimization: bool = False,
        denoise_mask_fn: Optional[Callable] = None,
        callback: Optional[Callable] = None,
        pre_cfg_fns: Optional[list] = None,
        sequential_cfg: bool = False,
        return_aux: bool = False,
    ):
        samplers.get_solver(sampler_name)  # an unknown name raises here
        self.model = model
        self.config = config
        self.sampler_name = sampler_name
        self.cfg = float(cfg)
        if cfg_big is None:
            cfg_big = resolve_cfg_big(prompt_mode, cfg, model.is_flux)
        self.cfg_big = float(cfg_big)
        self.disable_cfg1_optimization = disable_cfg1_optimization
        self.denoise_mask_fn = denoise_mask_fn
        self.callback = callback
        self.pre_cfg_fns = pre_cfg_fns
        # two B-sized model calls instead of one 2B-sized (same math)
        self.sequential_cfg = sequential_cfg
        self.return_aux = return_aux

    def __call__(
        self,
        *,
        latent,
        sigmas,
        cond: Any,
        uncond: Any = None,
        mask=None,
        seed: int = 0,
        noise=None,
        add_noise: bool = True,
        decoupled_noise: bool = False,
        video: bool = False,
        noise_feed=None,
        batch_rows: Optional[tuple] = None,
    ):
        """Run sampling.  Returns (samples, denoised_history), or with
        `return_aux` (samples, denoised_history, aux).

        `noise` overrides the seed-derived initial noise.  `decoupled_noise`:
        the think loop's replace-step noise comes from a second generator
        seeded `seed + 1` (reference nodes.py:208-212) instead of being the
        initial noise.  `noise_feed` (parity/replay mode): (total_steps, n_max, 5,
        *latent.shape) standard-normal draws the think loop consumes instead
        of the generator, row per outer step (engine.lanpaint_update
        contract), the step of a model call being that of its nearest ladder
        sigma (`samplers.model_step`; the row index clamped to the feed).
        `batch_rows` (data parallelism, `parallel.with_data_parallel`):
        (rows, batch): this call computes rows `rows` (a slice) of a batch
        of `batch`; every random tensor is drawn for the whole batch and
        cut to these rows (`engine.BatchRows`), so the result is those rows
        of the one-process run.

        RNG order: one `torch.Generator` on the latent's device, seeded with
        the seed's low 32 bits, draws the initial noise (unless `noise` is
        given or add_noise is off), then serves every think loop in
        outer-step order (engine.py documents its draws).

        The call is a `sampler.job` span and each model-function call of
        the solver a `sampler.step` span (`telemetry`)."""
        latent = torch.as_tensor(latent)
        device = latent.device
        sig_host = np.asarray(sigmas, dtype=np.float32)
        kind = self.model.kind
        total = int(sig_host.shape[0]) - 1
        with telemetry.span("sampler.job", device=device, sampler=self.sampler_name,
                            steps=total, batch=int(latent.shape[0])):
            seed = _seed32(seed)
            gen = torch.Generator(device=device).manual_seed(seed)
            if batch_rows is not None:
                gen = BatchRows(gen, *batch_rows)

            if noise is not None:
                noise = torch.as_tensor(noise, device=device, dtype=torch.float32)
            elif add_noise:
                noise = randn(latent.shape, gen, device)
            else:
                noise = torch.zeros(latent.shape, dtype=torch.float32, device=device)
            think_noise = noise
            if decoupled_noise:
                think_gen = torch.Generator(device=device).manual_seed((seed + 1) & 0xFFFFFFFF)
                if batch_rows is not None:
                    think_gen = BatchRows(think_gen, *batch_rows)
                think_noise = randn(latent.shape, think_gen, device)
            b = latent.shape[0]
            x_init = noise_scaling(
                kind, torch.full((b,), float(sig_host[0]), device=device), noise, latent,
                max_denoise=_max_denoise(sig_host, self.model.sigma_table))
            sig_last = torch.as_tensor(sig_host[-1:], device=device)
            if total <= 0:
                out = (inverse_noise_scaling(kind, sig_last, x_init),
                       x_init.new_zeros((0,) + tuple(x_init.shape)))
                return out + (None,) if self.return_aux else out

            cond = _to_device(cond, device)
            uncond = None if uncond is None else _to_device(uncond, device)
            if self.model.precompute is not None:
                cond = self.model.precompute(cond)
                if uncond is not None:
                    uncond = self.model.precompute(uncond)
            denoise_at = self._denoise_at(cond, uncond)

            def host_times(sigma):
                # unified times on the CPU from the host sigma: the engine decides
                # its loop length, and the sampler the expert, there without a
                # device sync
                return unify_times(torch.full((b,), float(sigma), dtype=torch.float32), kind)

            if mask is None:
                def wrapped(x, sigma, step):
                    with telemetry.span("sampler.step", step=step):
                        times = host_times(sigma)
                        t = times.flow_t if kind is ModelKind.FLOW else times.ve_sigma
                        out, _ = denoise_at(times)(x, t.to(device))
                    return out, x
            else:
                wrapped = self._inpaint_step(
                    denoise_at, host_times, prepare_mask(torch.as_tensor(mask, device=device),
                                                         latent.shape, video),
                    latent, think_noise, total, gen, noise_feed)

            collect = self.return_aux and mask is not None
            x, den_all = samplers.sample(wrapped, x_init, sig_host, sampler=self.sampler_name,
                                         generator=gen, callback=self.callback,
                                         collect_aux=collect)
            samples = inverse_noise_scaling(kind, sig_last, x)
            if not self.return_aux:
                return samples, den_all
            aux = None
            if collect:
                den_all, auxs = den_all
                aux = ThinkAux(steps_done=torch.tensor([a.steps_done for a in auxs],
                                                       dtype=torch.int32),
                               trace=torch.stack([a.trace for a in auxs]))
            return samples, den_all, aux

    def _denoise_at(self, cond, uncond):
        """`denoise_at(times)`: the CFG double denoiser over the model, or
        over the expert its `route` picks from the host model time (the
        batch mean of `times`' flow t, or VE sigma for an EPS model, as JAX's
        `mean(t)`), one built per expert."""
        built = {}

        def denoise_at(times):
            apply = self.model.apply
            if self.model.route is not None:
                t = times.flow_t if self.model.kind is ModelKind.FLOW else times.ve_sigma
                apply = self.model.route(float(t.mean()))
            if apply not in built:
                built[apply] = make_cfg_double_denoiser(
                    apply, cond, uncond, self.cfg, self.cfg_big,
                    self.disable_cfg1_optimization, self.pre_cfg_fns,
                    sequential=self.sequential_cfg)
            return built[apply]

        return denoise_at

    def _inpaint_step(self, denoise_at, host_times, denoise_mask, latent, think_noise, total,
                      gen, noise_feed):
        """The solver's model function on the inpaint path: one
        `lanpaint_update` (think loop, final denoise, known-region blend)."""
        cfg_ = self.config
        kind = self.model.kind
        device = latent.device
        if noise_feed is not None:
            noise_feed = torch.as_tensor(noise_feed)
        fixed_mask = (None if self.denoise_mask_fn is not None
                      else 1.0 - (denoise_mask > 0.5).float())

        def wrapped(x, sigma, step):
            with telemetry.span("sampler.step", step=step):
                latent_mask = fixed_mask
                if latent_mask is None:
                    dm = self.denoise_mask_fn(torch.tensor(float(sigma), device=device),
                                              denoise_mask)
                    latent_mask = 1.0 - (dm > 0.5).float()
                # Outer early stop: zero think steps in the tail (nodes.py:177-183).
                n = 0 if total - step <= cfg_.outer_early_stop else cfg_.n_steps
                times = host_times(sigma)
                out, x_new, aux = lanpaint_update(
                    denoise_at(times), x, latent_image=latent, noise=think_noise,
                    latent_mask=latent_mask, times=times, n_steps=n, config=cfg_, kind=kind,
                    generator=gen,
                    noise_feed=None if noise_feed is None
                    else noise_feed[min(step, noise_feed.shape[0] - 1)])
            return (out, x_new, aux) if self.return_aux else (out, x_new)

        return wrapped


# ---------------------------------------------------------------------------
# Node-equivalent convenience entry points


def _build_sigmas(model: Denoiser, scheduler: str, steps: int, denoise: float = 1.0):
    if model.sigma_table is None:
        raise ValueError("model has no sigma_table; pass explicit sigmas")
    return apply_denoise(model.sigma_table, scheduler, steps, denoise)


def _fill_trace(trace: dict, aux) -> None:
    """Copy a ThinkAux into a user-supplied trace dict (host numpy)."""
    trace["steps_done"] = None if aux is None else aux.steps_done.cpu().numpy()
    trace["trace"] = None if aux is None else aux.trace.cpu().numpy()


def ksampler(
    model: Denoiser,
    *,
    seed: int = 0,
    steps: int = 30,
    cfg: float = 5.0,
    sampler_name: str = "euler",
    scheduler: str = "karras",
    positive: Any,
    negative: Any = None,
    latent,
    mask=None,
    denoise: float = 1.0,
    num_steps: int = 5,
    prompt_mode: str = "Image First",
    video: bool = False,
    sequential_cfg: bool = False,
    noise=None,
    callback: Optional[Callable] = None,
    trace: Optional[dict] = None,
):
    """LanPaint_KSampler equivalent with the reference defaults
    (StepSize=0.2, Lambda=16, Beta=1, Friction=15, EarlyStop=1; reference
    nodes.py:329-336).  Returns the samples.

    `noise` overrides the seed-derived initial noise; `callback(i,
    denoised, x)` fires after each outer step.  `trace`: pass a dict to
    receive the think-loop diagnostics, "steps_done" ((steps,) int,
    Langevin iterations spent per outer step) and "trace" ((steps, n_max,
    8) rows [inner_step, dist, dist_inpaint, dist_ring, dist_drift,
    threshold, patience, stopped]; the reference's
    model_options["lanpaint_semantic_trace"], earlystop.py:315-334)."""
    config = LanPaintConfig(n_steps=num_steps, record_trace=trace is not None)
    sam = LanPaintSampler(model, config=config, sampler_name=sampler_name, cfg=cfg,
                          prompt_mode=prompt_mode, sequential_cfg=sequential_cfg,
                          callback=callback, return_aux=trace is not None)
    out = sam(latent=latent, sigmas=_build_sigmas(model, scheduler, steps, denoise),
              cond=positive, uncond=negative, mask=mask, seed=seed, video=video, noise=noise)
    if trace is not None:
        _fill_trace(trace, out[2])
    return out[0]


def ksampler_advanced(
    model: Denoiser,
    *,
    add_noise: bool = True,
    noise_seed: int = 0,
    steps: int = 30,
    cfg: float = 5.0,
    sampler_name: str = "euler",
    scheduler: str = "karras",
    positive: Any,
    negative: Any = None,
    latent,
    mask=None,
    start_at_step: int = 0,
    end_at_step: int = 10000,
    return_with_leftover_noise: bool = False,
    num_steps: int = 5,
    lamb: float = 16.0,
    step_size: float = 0.2,
    beta: float = 1.0,
    friction: float = 15.0,
    prompt_mode: str = "Image First",
    early_stop: int = 1,
    inner_threshold: float = 0.0,
    inner_patience: int = 1,
    video: bool = False,
    sequential_cfg: bool = False,
    trace: Optional[dict] = None,
):
    """LanPaint_KSamplerAdvanced equivalent: the full hyperparameter surface
    (reference nodes.py:350-413), steps [start_at_step, end_at_step) of the
    scheduler's ladder; the last sigma is 0 unless
    `return_with_leftover_noise`.  `trace`: see `ksampler`."""
    config = LanPaintConfig(
        n_steps=num_steps, lamb=lamb, step_size=step_size, beta=beta, friction=friction,
        outer_early_stop=early_stop, inner_threshold=inner_threshold,
        inner_patience=inner_patience, record_trace=trace is not None)
    sigmas = np.asarray(calculate_sigmas(model.sigma_table, scheduler, steps))
    sigmas = sigmas[start_at_step:min(end_at_step, steps) + 1].copy()
    if len(sigmas) == 0:
        return latent
    if not return_with_leftover_noise:
        sigmas[-1] = 0.0
    sam = LanPaintSampler(model, config=config, sampler_name=sampler_name, cfg=cfg,
                          prompt_mode=prompt_mode, sequential_cfg=sequential_cfg,
                          return_aux=trace is not None)
    out = sam(latent=latent, sigmas=sigmas, cond=positive, uncond=negative, mask=mask,
              seed=noise_seed, add_noise=add_noise, video=video)
    if trace is not None:
        _fill_trace(trace, out[2])
    return out[0]


def _last_denoised(model: Denoiser, den_all):
    denoised = den_all[-1]
    if model.process_latent_out is not None:
        denoised = model.process_latent_out(denoised)
    return denoised


def sample_custom(
    model: Denoiser,
    *,
    add_noise: bool = True,
    noise_seed: int = 0,
    cfg: float = 8.0,
    positive: Any,
    negative: Any = None,
    sampler_name: str = "euler",
    sigmas,
    latent,
    mask=None,
    num_steps: int = 5,
    prompt_mode: str = "Image First",
    video: bool = False,
    sequential_cfg: bool = False,
):
    """LanPaint_SamplerCustom equivalent: a caller-supplied sigma ladder;
    returns (output, denoised_output) (reference nodes.py:491-556)."""
    sam = LanPaintSampler(model, config=LanPaintConfig(n_steps=num_steps),
                          sampler_name=sampler_name, cfg=cfg, prompt_mode=prompt_mode,
                          sequential_cfg=sequential_cfg)
    samples, den_all = sam(latent=latent, sigmas=sigmas, cond=positive, uncond=negative,
                           mask=mask, seed=noise_seed, add_noise=add_noise, video=video)
    return samples, _last_denoised(model, den_all)


def sample_custom_advanced(
    model: Denoiser,
    *,
    noise_seed: int = 0,
    noise=None,
    cfg: float = 8.0,
    positive: Any,
    negative: Any = None,
    sampler_name: str = "euler",
    sigmas,
    latent,
    mask=None,
    num_steps: int = 5,
    lamb: float = 16.0,
    step_size: float = 0.2,
    beta: float = 1.0,
    friction: float = 15.0,
    prompt_mode: str = "Image First",
    early_stop: int = 1,
    inner_threshold: float = 0.0,
    inner_patience: int = 1,
    video: bool = False,
    sequential_cfg: bool = False,
):
    """LanPaint_SamplerCustomAdvanced equivalent: the full hyperparameter
    surface, a custom ladder and caller-supplied noise (reference
    nodes.py:558-626); returns (output, denoised_output)."""
    config = LanPaintConfig(
        n_steps=num_steps, lamb=lamb, step_size=step_size, beta=beta, friction=friction,
        outer_early_stop=early_stop, inner_threshold=inner_threshold,
        inner_patience=inner_patience)
    sam = LanPaintSampler(model, config=config, sampler_name=sampler_name, cfg=cfg,
                          prompt_mode=prompt_mode, sequential_cfg=sequential_cfg)
    samples, den_all = sam(latent=latent, sigmas=sigmas, cond=positive, uncond=negative,
                           mask=mask, seed=noise_seed, noise=noise, video=video)
    return samples, _last_denoised(model, den_all)


@torch.no_grad()
def inpaint_image(
    model: Denoiser,
    vae,
    *,
    image,
    mask,
    positive: Any,
    negative: Any = None,
    seed: int = 0,
    steps: int = 30,
    cfg: float = 5.0,
    sampler_name: str = "euler",
    scheduler: str = "karras",
    num_steps: int = 5,
    prompt_mode: str = "Image First",
    blend_overlap: int = 9,
    **sampler_kwargs,
):
    """Pixel-space inpainting: VAE encode -> LanPaint ksampler -> VAE decode
    -> MaskBlend, the workflow the reference's example graphs run through
    their host (e.g. example_workflows/SDXL_Inpaint.json), as one call.

    `vae` is a `models.vae.VAE` (weights inside); `image` (B, 3, H, W) in
    [-1, 1] with H and W multiples of 8; `mask` an (H, W) pixel mask, 1 =
    repaint.  Returns (B, 3, H, W); where the dilated, feathered mask is 0
    the result is `image` exactly."""
    latent = vae.encode(image)
    out_latent = ksampler(
        model, seed=seed, steps=steps, cfg=cfg, sampler_name=sampler_name,
        scheduler=scheduler, positive=positive, negative=negative, latent=latent, mask=mask,
        num_steps=num_steps, prompt_mode=prompt_mode, **sampler_kwargs)
    decoded = vae.decode(out_latent)
    if blend_overlap <= 0:
        return decoded
    img_hwc = image.permute(0, 2, 3, 1)
    dec_hwc = decoded.permute(0, 2, 3, 1).to(img_hwc.dtype)
    m = torch.as_tensor(mask, dtype=torch.float32, device=image.device)
    if m.ndim == 2:
        m = m[None]
    m = torch.broadcast_to(m, img_hwc.shape[:3])
    return mask_blend(img_hwc, dec_hwc, m, blend_overlap=blend_overlap).permute(0, 3, 1, 2)


def outpaint_image(model: Denoiser, vae, *, image, padding, positive: Any, **kw):
    """Outpainting (reference Qwen_Image_Outpainting workflow): grow the
    canvas by `padding` = (top, bottom, left, right) pixels (multiples of
    the VAE stride), edge-replicate the source into the new border, mask
    the border as the repaint region, and run `inpaint_image`.  Returns the
    (B, 3, H+t+b, W+l+r) canvas."""
    t, b, lft, r = padding
    canvas = F.pad(torch.as_tensor(image).float(), (lft, r, t, b), mode="replicate")
    hh, ww = canvas.shape[2], canvas.shape[3]
    mask = torch.ones((hh, ww), dtype=torch.float32, device=canvas.device)
    mask[t:hh - b, lft:ww - r] = 0.0
    return inpaint_image(model, vae, image=canvas, mask=mask, positive=positive, **kw)


@torch.no_grad()
def edit_image(model: Denoiser, vae, *, image, mask, positive: Any, negative: Any = None,
               blend_overlap: int = 9, **sampler_kwargs):
    """Qwen-Image-Edit masked edit: the source image conditions the DiT as
    packed reference latents appended to the image token stream (the
    reference workflow's ReferenceLatent path, Qwen_Image_Edit_2509.json),
    on top of `inpaint_image`'s VAE encode -> LanPaint -> decode ->
    MaskBlend.  The reference tokens go into each cond dict as
    "ref_tokens" unless it has them already.

    For the full reference conditioning also pass `positive` built by
    `text.encode_prompt(family="qwen_edit", vision=..., image=...)`, which
    adds the Qwen2.5-VL vision tokens to the prompt sequence.  `image` is
    (B, 3, H, W) in [-1, 1]; `mask` (H, W) with 1 = the region to edit."""
    from .models.dit import pack_latent

    ref = pack_latent(vae.encode(image), 2)

    def with_ref(cond):
        if not isinstance(cond, dict):
            return cond
        out = dict(cond)
        out.setdefault("ref_tokens", ref)
        return out

    return inpaint_image(model, vae, image=image, mask=mask, positive=with_ref(positive),
                         negative=with_ref(negative), blend_overlap=blend_overlap,
                         **sampler_kwargs)


@torch.no_grad()
def inpaint_video(
    model: Denoiser,
    vae,
    *,
    video,
    mask,
    positive: Any,
    negative: Any = None,
    seed: int = 0,
    steps: int = 20,
    cfg: float = 5.0,
    sampler_name: str = "euler",
    scheduler: str = "simple",
    num_steps: int = 2,
    prompt_mode: str = "Image First",
    blend_overlap: int = 9,
    **sampler_kwargs,
):
    """Pixel-space video inpainting: Wan VAE encode -> LanPaint (the video
    mask path) -> decode -> per-frame MaskBlend, the graph the reference's
    video workflows run through their host (reference README.md:205-268).

    `vae` is a `models.video_vae.WanVAE` (weights inside); `video` (B, 3, T,
    H, W) in [-1, 1] with T = 1 + 4k and H, W multiples of the VAE's
    spatial stride (8 for Wan2.1, 16 for Wan2.2); `mask` a (T, H, W) or
    (H, W) pixel mask, 1 = repaint (a 2D mask applies to every frame).
    Returns (B, 3, T, H, W); where the dilated, feathered mask is 0 the
    result is `video` exactly.

    The call is a `pipeline.video` span (`telemetry`: a job record of its
    own, the sampler's `sampler.job` inside it) holding `vae.encode`,
    `vae.decode` and `video.blend` spans."""
    device = video.device
    b, _, t, hh, ww = video.shape
    with telemetry.span("pipeline.video", device=device, frames=t, height=hh,
                        width=ww) as job:
        with telemetry.span("vae.encode", device=device):
            latent = vae.encode(video)
        job.attrs["tokens"] = _backbone_tokens(model, latent.shape)
        out_latent = ksampler(
            model, seed=seed, steps=steps, cfg=cfg, sampler_name=sampler_name,
            scheduler=scheduler, positive=positive, negative=negative, latent=latent,
            mask=mask, num_steps=num_steps, prompt_mode=prompt_mode, video=True,
            **sampler_kwargs)
        with telemetry.span("vae.decode", device=device):
            decoded = vae.decode(out_latent)
        if blend_overlap <= 0:
            return decoded
        with telemetry.span("video.blend", device=device):
            m = torch.as_tensor(mask, dtype=torch.float32, device=device)
            if m.ndim == 2:
                m = m[None]
            # fold the frames into the batch axis for the 2D blend
            img_hwc = video.permute(0, 2, 3, 4, 1).reshape(b * t, hh, ww, 3)
            dec_hwc = decoded.permute(0, 2, 3, 4, 1).reshape(b * t, hh, ww, 3).to(img_hwc.dtype)
            mf = torch.broadcast_to(m, (b, t, hh, ww)).reshape(b * t, hh, ww)
            blended = mask_blend(img_hwc, dec_hwc, mf, blend_overlap=blend_overlap)
            return blended.reshape(b, t, hh, ww, 3).permute(0, 4, 1, 2, 3)


def _backbone_tokens(model: Denoiser, latent_shape):
    """The backbone's tokens a sample for a (B, C, F, h, w) latent: its
    positions over the module's (pf, ph, pw) patch, or None where the
    module has no one patch (an expert pair)."""
    patch = getattr(getattr(model.module, "cfg", None), "patch", None)
    return None if patch is None else math.prod(latent_shape[2:]) // math.prod(patch)
