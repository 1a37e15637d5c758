#!/usr/bin/env python3
"""Drive lanpaint_tpu_torch's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py          # from the root of the repository

Eighteen main paths, each with random bf16 weights made on the card from a
seed, the euler solver, 20 steps (Z-Image's 9, FLUX.2's and the parallel
path's 4), outer early stop 1 and a centre mask; 5 think steps but for the
video, FLUX.2 and parallel paths' 2:

* SDXL-1024: karras, CFG 5 as two sequential passes, the unfused think
  step: (20 - 1) * 6 + 1 = 115 CFG pairs, 230 UNet forwards;
* pixel-space SDXL-1024 (the reference's SDXL_Inpaint workflow through
  `api.inpaint_image`): the SDXL VAE encodes a random 1024^2 image, the
  SDXL path above repaints the latent, the VAE decodes it and MaskBlend
  (overlap 9) feathers it into the image: two wide-head attention launches
  (the VAE's mid attention, D = 512, S = 16,384) besides the SDXL path's;
  its conds are the pipeline path's prompt encodings;
* single-file SDXL-1024 through `LanPaintPipeline` (the reference user's
  node graph as one object): the SDXL UNet and VAE above with a CLIP-L and
  a CLIP-G, exported into one BF16 safetensors file (3.469 B parameters),
  read back with `from_single_file`, a prompt encoded by the port's
  tokenizer and CLIP towers, then `pipe(prompt, image=..., mask=...)` with
  the pixel path's settings: bit-equal to the pixel path's output;
* single-file SD1.5 at its published 512^2 through the same pipeline
  (SD15_CONFIG's first run on the card): its attention (head dims 40, 80,
  160) stays plain as in the JAX package, its LayerNorms and the VAE's mid
  attention (D = 512, S = 4,096) take the kernels;
* Flux-dev-1024 (the reference's Flux_Inpaint workflow): "simple", cfg 1
  (cfg_big forced to 1), `use_fused_kernels=True`: 115 MMDiT forwards, 76
  fused half-step and 95 fused finish launches;
* FLUX.2 [dev] at its published widths (`zoo.build_flux2_dev`, 32.22 B
  parameters, 64.4 GB) at the benchmark cell's 1248x832 with its reference
  latent: `api.ksampler`, "simple", cfg 1, guidance 4, 4 steps x 2 think:
  10 forwards at S = 512 + 4,056 + 4,056 = 8,624, each 56 attention, 81
  LayerNorm and 128 RoPE row-norm launches, 3 shared modulations and 64
  SwiGLU calls;
* Wan2.2 TI2V-5B video (the reference's video workflows through
  `api.inpaint_video` with its defaults): "simple", 2 think steps, CFG 5 as
  two sequential passes, on a random (1, 3, 33, 704, 1280) video (TI2V-5B's
  published 704x1280 with 33 of its 121 frames) and the Wan2.2 VAE: a
  (1, 48, 9, 44, 80) latent, S = 7,920 tokens, (20 - 1) * 3 + 1 = 58 CFG
  pairs, 116 DiT forwards, and two wide-head attention launches (the VAE's
  mid attention, D = 640, over 9 frames of 3,520 tokens);
* Wan2.2 T2V-A14B video (the reference's own video workflow, the 14B
  high/low-noise expert pair, through `api.inpaint_video` with its
  defaults): `zoo.switching_denoiser` over two WAN22_T2V_14B_CONFIG experts
  (hidden 5,120, 40 heads, 40 blocks; seeds 0 and 1) at the Wan2.2
  boundary t = 0.875, the Wan2.1 VAE, a random (1, 3, 33, 480, 832) video
  (the pair's published 480p with 33 of its 81 frames): a (1, 16, 9, 60,
  104) latent, S = 14,040 tokens, 58 CFG pairs, 116 DiT forwards, 54 of
  them the high-noise expert's (the first 9 steps have t >= 0.875) and 62
  the low-noise one's, and two wide-head launches at D = 384;
* Z-Image-1024 (the reference's Z_image_Inpaint workflow) through
  `LanPaintPipeline.from_components(family="z-image")`: Z_IMAGE_S3_CONFIG,
  the Qwen3-4B trunk and the Flux VAE handed over as exported state dicts,
  a synthetic byte-level BPE of Qwen's vocabulary, then the pipeline's
  call: "simple", 9 steps, cfg 1: (9 - 1) * 6 + 1 = 49 forwards at S =
  n_txt + 4,096, two wide-head launches (D = 512);
* Qwen-Image-Edit-1024 (the reference's Qwen_Image_Edit_2509 workflow):
  the Qwen2.5-VL-7B text trunk and vision tower (fp32) encode the prompt
  with the source image (`encode_prompt(family="qwen_edit")`) and are
  released, then `build_qwen_image` and the Wan2.1-graph VAE at one frame
  run `api.edit_image`: "simple", cfg 1, shift 2.2, 115 forwards at S =
  n_txt + 8,192 (4,096 reference tokens), three wide-head launches at
  D = 384 (the reference latents' encode, the latent's, the decode);
* SD3.5-Large-1024 from pixels (examples/sd35_inpaint.py) through
  `LanPaintPipeline.from_components(family="sd35")`: the SD35_LARGE_CONFIG
  MMDiT and the SD3 VAE (bf16), CLIP-L, CLIP-G and T5-XXL (fp32,
  `encoder_dtype`) handed over as exported states, then the pipeline's
  call: "simple", CFG 4.5 as two sequential passes: 230 forwards at S =
  231 + 4,096 (H = 38, D = 64), two wide-head launches (D = 512);
* HiDream-I1-1024 (examples/hidream_inpaint.py): T5-XXL (128 tokens),
  CLIP-L, CLIP-G and the Llama-3.1-8B trunk (fp32) encode through
  `encode_prompt(family="hidream")` and are released, then
  `build_hidream` runs `api.ksampler`: "simple", cfg 1, 115 forwards on a
  (1, 16, 128, 128) latent;
* HunyuanVideo-720p as a single-frame 1024^2 T2I (the reference's Hunyuan
  workflow, examples/hunyuan_inpaint.py): the Llama-3.1-8B trunk and
  CLIP-L (fp32) encode through `encode_prompt(family="hyvideo")` (the
  image template, 36 states cropped) and are released, then
  `build_hyvideo` runs `api.ksampler` with guidance 6.0: "simple", cfg 1,
  115 forwards on a 4D latent run as one frame;
* SDXL-1024 with a ControlNet (`zoo.build_controlled_unet(SDXL_CONFIG,
  ...)`: the SDXL path's UNet weights and a ControlNet of 1.251 B random
  parameters, its zero convs drawn too): the SDXL path's settings with a
  seeded 1024^2 hint in both conds at strength 1: 230 forwards of the UNet
  and the ControlNet, 104 self-attention and 312 LayerNorm launches each;
* serving (`python -m lanpaint_tpu_torch serve`, as `cmd_serve` stands it
  up): the single-file SDXL checkpoint with a seeded rank-8 kohya LoRA
  merged at 0.8 (`models.lora.apply_lora`), read by
  `from_single_file(state=...)`, behind `serve.InpaintServer` (batch 2,
  `pipeline_runner`, `pipeline_validator`) and `serve.make_http_server` on
  127.0.0.1: three 1024^2 requests POSTed over HTTP at the default
  `Variant` (euler karras 20 x 5, cfg 5 batched: 115 UNet forwards at
  batch 4 a batch), in two batches (a co-batched pair, a padded lone
  request), and one request of a wrong shape that fails alone;
* the parallel path (`lanpaint_tpu_torch.parallel`) at a world of one over
  NCCL: TI2V-5B through `zoo.build_wan_seq_parallel(..., tp_axis="tensor")`
  on a (data, seq, tensor, expert) = (1, 1, 1, 1) mesh, ring self-attention
  at S = 7,920, the video path's latent, euler "simple" 2 x 2 think, cfg 1:
  4 forwards;
* the 17 example scripts of `lanpaint_tpu_torch/examples/` in --smoke mode
  on the card (tiny random models, each the twin of one of examples/);
* the tensor-parallel path: two processes on the one card, a gloo world of
  2 (CUDA tensors, collectives staged through the host), each holding its
  tensor-2 shard of SDXL-1024 (`zoo.build_unet(..., mesh=..., tp_axis=
  "tensor")`: every transformer block on half the heads), euler karras 4 x
  2 think, cfg 1: 10 forwards a rank.

Phases, one line of output each or more (any failure raises and the script
exits non-zero without printing a result):

1. device: nvidia-smi's name and power limit, torch and CUDA versions, the
   TF32 flags in force; then `python -m lanpaint_tpu_torch info` in a
   subprocess (exit 0, the card named);
2. build: one nvcc per CUDA source in csrc/ (the D <= 128 and the
   wide-head attention libraries, the row norm, the fused think-step
   kernels), all started together; seconds for each, and ptxas's register
   and spill counts for each kernel instantiation
   (none may spill, and ptxas must not ignore either attention kernel's
   setmaxnreg); the count of wgmma (HGMMA) and TMA load (UTMALDG)
   instructions in the SASS of each attention instantiation (cuobjdump
   -sass; neither may be 0);
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes (plus ragged shapes, and SD2.1-v-768's two
   D = 64 attention shapes, S = 9,216 and 2,304), with each kernel's
   time, the plain version's and, where one PyTorch call computes the same
   function (scaled_dot_product_attention, F.layer_norm, F.rms_norm), that
   call's, timed as a yardstick only: per launch including the host's
   launch work (CUDA events, median of 20) and on the device (`device_us`);
   beside them each call's bound, the larger of its bytes over 3.35 TB/s
   and its operations over the peak of their type (989 TFLOP/s bf16 on
   the tensor cores, 67 TFLOP/s fp32 elsewhere), and for attention the
   achieved TFLOP/s and its share of the bound;
   for the fused kernels also each phase at noise_mult=1 against its plain
   version fed `fused.philox_normals` (the kernel's draw, made on the CPU),
   a non-finite coefficient case, the noise statistics at noise_mult=1,
   and the non-model time of a think step, fused against plain, at the
   SDXL and Flux latent sizes;
4. small UNet reference and 5. small DiT reference: a small model whose
   attention and norms go through the kernels, on the card in bf16 against
   the same weights in fp32 on the CPU, beside the CPU's own bf16 plain
   path: one forward, and a 4-step LanPaint run with a shared think-noise
   feed; for the UNet also the same run with each of the 22 solvers (a
   shared solver-noise draw too), and `zoo.dual_model_denoiser` over two
   small UNets with sequential CFG, its calls of each model counted;
4b. small controlled UNet reference (after phase 4): phase 4's check on
   the small UNet with a ControlNet at strength 1, its zero convs drawn,
   a seeded hint in both conds;
6. SDXL main path and 8. Flux main path: build, then LanPaintSampler twice
   (the first a 2-step warm-up); the second run is timed
   and its kernels counted in the card's trace (`telemetry.card_kernels`,
   a UNet's graph replays among them): the output is finite, the known
   region equals the latent, the repainted region moved, and every kernel
   ran exactly its expected number of times (and where the run replayed
   no graph, the wrappers issued exactly that); then one Flux forward under
   torch.profiler (kernel time against wall clock, the largest kernels);
7. pixel path (phase 6's UNet, the SDXL VAE): the VAE's encode and decode
   timed alone, then one `api.inpaint_image` run, timed and counted: the
   output is finite and (1, 3, 1024, 1024), every pixel farther than the
   blend overlap from the mask equals the input bit for bit, the repainted
   region moved, and every kernel ran exactly its expected number of times
   (the wide-head attention twice);
8b. FLUX.2 main path (after phase 9): phase 8's checks on
   `build_flux2_dev` through `api.ksampler`, its shared modulations and
   SwiGLU calls counted too; one forward under torch.profiler first;
9. Flux VAE: one encode-decode round trip of FLUX_VAE_CONFIG (16 latent
   channels, no quant convs) at 1024^2 through the wide-head kernel;
10. video path (Wan2.2 TI2V-5B and the Wan2.2 VAE): the VAE's encode and
   decode timed alone, one DiT forward under torch.profiler (kernel time
   against wall clock: the card's idle share), a 2-step warm-up call of
   `api.inpaint_video`, then one timed and counted call with its defaults:
   the output is finite and of the input's shape, every pixel of every
   frame farther than the blend overlap from the mask equals the input bit
   for bit, the repainted region moved, and every kernel ran exactly its
   expected number of times (the wide-head attention twice);
11. pair path (the two experts and the Wan2.1 VAE): the VAE's encode and
   decode timed alone (its latent checked; the mid attention runs the
   wide-head kernel at D = 384), one forward of each expert (at t = 0.9 and
   t = 0.7, routed by the pair) under torch.profiler, a 2-step warm-up call
   of `api.inpaint_video` (its ladder 1.0, 0.833, 0 runs both experts),
   then one timed and counted call with its defaults: phase 10's checks,
   and each expert's forwards counted;
12. single file, SDXL (run between phases 6 and 7, on their models): the
   export, the file's write (a small writer here: the card's machine has
   no safetensors package), `from_single_file` timed by step (the native
   reader's read, split and import, the copy to the card), the tensors the
   native reader widened (all of them, none by torch), the family and the
   encoders, every tensor bit-equal to its source, `pipe.encode` timed;
   after phase 7, the pipeline's call, timed and counted with phase 7's
   checks and bit-equal to phase 7's output;
13. single file, SD1.5 at 512^2: the same load checks, then the
   pipeline's call and `inpaint_image` on the source modules with the
   pipeline's prompt encodings, each timed and counted with phase 7's
   checks, bit-equal to each other;
14. the T5 text encoders at full width, fp32: T5-XXL and UMT5-XXL, one at
   a time, one prompt at 512 tokens through `text.NativeEncoder`:
   (1, 512, 4096), finite, timed;
5b. small Z-Image reference (after phase 5): phase 5's check on a small
   Z-Image (hidden 256, D = 128, GQA 2 -> 1 heads) at 1,024 image tokens;
15. Z-Image path: the sources' weights bit-equal to the pipeline's, encode
   timed, one forward under torch.profiler, then the pipeline's call,
   timed and counted with phase 7's checks;
16b. `from_components(family="qwen", with_vision=True)` at full width and
   depth 2 (DiT, text trunk, vision tower): weights bit-equal to the
   sources, encode with and without the image, a 2-step pipeline call with
   the edit conditioning and phase 7's checks;
16. Qwen-Image-Edit path: the encode (first call, then median of 3, the
   vision tower alone, the encoders' peak memory), the VAE timed, one
   forward under torch.profiler, then `edit_image`, timed and counted with
   phase 7's checks.  Phase 3 also holds each kernel at these paths'
   shapes (their text lengths come from the synthetic tokenizer);
5c. small SD3, HiDream and HunyuanVideo references (after phase 5b):
   phase 5's check on small models (hidden 256; D = 64 with one
   dual-attention layer, D = 128 with the 4-expert MoE, D = 128 with one
   refiner block) at 2,304 image tokens;
17. SD3.5-Large path: the sources built one at a time, exported to the
   host and released, loaded by `from_components`, every tensor bit-equal
   to its source (rebuilt from its seed), encode timed, one forward under
   torch.profiler, then the pipeline's call, timed and counted with phase
   7's checks;
18. HiDream-I1 path and 19. HunyuanVideo path: the encode (first call,
   then median of 3, the encoders' peak memory), the encoders released,
   the DiT built, one forward under torch.profiler, a 2-step warm-up, then
   `api.ksampler`, timed and counted with phase 6's checks.  Phase 3 holds
   each kernel at these paths' shapes too (the synthetic Llama-3.1
   tokenizer, 128,256 ids, gives the text lengths);
20. ControlNet path (after phase 12's pipeline call, on phase 6's UNet
   state): the ControlNet's 9 skip residuals and middle residual finite,
   one forward of the pair at strength 0 bit-equal to its forward without
   a hint, one forward with the hint and one without under
   torch.profiler (idle share, device time by kernel class), then phase
   6's run at strength 1 after a 2-step warm-up (timed and counted, phase
   6's checks), and one forward at strength 1 different from the forward
   without a hint;
21. serving path (phase 12's file, kept until then): the file read back
   with `load_safetensors` (numpy fp32), the LoRA merge timed on the host,
   a strength-0 merge bit-equal to the source, one merged weight against
   float64, the merged pipeline's UNet forward different from phase 12's;
   then the server on an ephemeral port: each answer of the right shape,
   finite, every pixel beyond the blend bit-equal to its input, the
   repainted region moved, two seeds' answers different, the bad request's
   HTTP 500 alone, /stats (3 served, 2 batches, 1 padded lane, 1 error),
   /progress polled while the first batch runs and done with
   `think_steps_done`, and exact launches in each batch (phase 3 holds the
   kernels at the batch-4 shapes: attention (4, 4096, 10, 64) and (4, 1024,
   20, 64), LayerNorm rows (16384, 640) and (4096, 1280), the VAE's wide
   head at (2, 16384, 1, 512));
22. parallel path (after phase 19; `parallel.init_world("cuda")`, a
   file-store NCCL group of one, destroyed with its store at the end of the
   phase): one TI2V-5B forward of `build_wan_seq_parallel` and one of
   `build_wan` on the same weights, each against `build_wan` in fp32 with
   plain fp32 attention on those weights (the seq-parallel error within
   twice `build_wan`'s) and timed; the sampler run, timed and
   counted (finite, the known region equal to the latent, the repainted
   region moved, exact launches: no flash attention, the ring replaces it);
   `ring_attention` at (1, 7920, 24, 128) against the flash kernel and an
   fp32 reference (its error within twice the kernel's), with the device
   times of the ring, the kernel and SDPA; the T2V-A14B pair's bf16 bytes
   per device at tensor 1, 2, 4, 8 (`tp_plan_bytes`, computed);
23. examples: the 17 scripts through runpy with their default device, the
   card (`serving_http` with --selftest, `wan22_seq_parallel` as a world of
   one): each exits 0 and reports a finite output; wall time and launches
   of each.  Each distinct kernel call they made (shapes, strides, dtypes,
   mode: recorded while they run) is then made again on fresh inputs of its
   layout, held against its plain version at phase 3's tolerance and timed
   (median of 5, host-inclusive; device times not measured): these rows
   join the kernels line with phase 23's launches;
24. the tensor-, expert- and layer-parallel builders (`zoo.build_unet`,
   `build_dit`, `build_sd3`, `build_hidream` with `mesh=`):
   24a (inside phases 6, 8, 17 and 18, on their resident weights): a world
   of one over NCCL, the family built from the phase's own state dict
   (views: no second copy) with `tp_axis`, HiDream's `expert_axis` and a
   layer axis, all of size 1; one forward against the phase's own (the
   model term's relative L2 within TP_REL_L2 = 5e-2: the row-parallel
   layers' bias after the reduce is one more bf16 rounding, bit-equal only
   because the seeded biases are zero), exact launches; after Flux's, its fused 2-step run through
   `with_data_parallel` bit-equal to the sampler's own run;
   24b (after phase 6): the tensor-parallel path above, both ranks' samples
   bit-equal, the first forward against the same weights in fp32 with
   plain attention within twice the one-process bf16 forward's error,
   exact launches a rank (70 attention at 5 and 10 heads, 210 LayerNorms
   a forward), a forward's time (one shared card, host-staged collectives:
   not a multi-card time);
   24c (after phase 22): bf16 bytes per device under the port's rules (the
   head rule included) for SDXL, Flux-dev, SD3.5-Large and HiDream-I1 at
   tensor 1, 2, 4, 8 and HiDream-I1 at expert 1, 2, 4 (computed).
   Phase 3 also holds the attention and strided RMS rows at the tensor-2
   shapes and both fused kernels at element offsets 3,003 (no multiple of
   4) and 16,384 against `philox_normals` at those offsets.

Then, on lines of their own: the nvidia-smi line, one JSON line with the
per-kernel numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
In the kernels line, `launches` is the seventeen main paths' count (phase
13's `inpaint_image` run, phase 16b's call, the warm-ups, phase 22's and
phase 24a's forwards are checks and not counted; phase 21's two batches
are one count, phase 23's 17 scripts one, and phase 24b's two ranks one),
and
`ms` /
`plain_ms` / `library_ms` / `bound_ms` are the kernel's / plain version's /
PyTorch call's per-launch times and the bound at each main-path shape times
that shape's launches in the seventeen main paths, summed (`library_ms` null
where a launched shape has no such call; each shape alone in `per_shape`,
with its device times in us, null for phase 23's shapes).

To run some phases alone: python3 -c "import chip_smoke as c; smi =
c.phase_device(); c.phase_build(); c.phase_pixel(smi)" (phases 15-16 take
the tokenizer and text lengths: tok = c.synthetic_qwen_tokenizer(); z, q
= c.text_lengths(tok); c.phase_zimage(smi, tok, z)).

It needs one CUDA card, the CUDA toolkit (nvcc, cuobjdump) and g++ (the
checkpoint reader's native conversion, built at first use); no network.
Phases 12 and 13 write their files into a temporary directory (~7 GB and
~2 GB) and remove it (phase 12's after phase 21, which reads it back and
holds its ~14 GB of fp32 arrays on the host while it merges); phase 17
holds ~39 GB of exported states on the host while it loads them.  Phase
21's server listens on 127.0.0.1 only, and its client ignores any proxy
setting.
"""

import collections
import contextlib
import dataclasses
import gc
import io
import itertools
import datetime
import json
import math
import multiprocessing
import os
import re
import runpy
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from lanpaint_tpu_torch import (LanPaintConfig, LanPaintPipeline, LanPaintSampler, ModelKind, api,
                                edit_image, inpaint_image, inpaint_video)
from lanpaint_tpu_torch.engine import lanpaint_update
from lanpaint_tpu_torch import parallel, pipeline, samplers, serve, telemetry, text, tokenizers
from lanpaint_tpu_torch.models import (dit, flux2, hidream, hyvideo, layers, load, lora, sd3,
                                       textenc, unet, vae, video_vae, vision, wan, zimage, zoo)
from lanpaint_tpu_torch.native import loader as native_loader
from lanpaint_tpu_torch.ops import attention, cuda_build, fused, norms
from lanpaint_tpu_torch.schedule import unify_times
from lanpaint_tpu_torch.sigmas import calculate_sigmas

STEPS, THINK, EARLY_STOP = 20, 5, 1
PAIRS = (STEPS - EARLY_STOP) * (THINK + 1) + EARLY_STOP     # 115
# the video path: inpaint_video's defaults (20 steps, 2 think steps)
VIDEO_THINK = 2
VIDEO_PAIRS = (STEPS - EARLY_STOP) * (VIDEO_THINK + 1) + EARLY_STOP  # 58
VIDEO_SHAPE = (1, 3, 33, 704, 1280)  # TI2V-5B's 704x1280, 33 of its 121 frames
WAN21_SHAPE = (1, 3, 33, 480, 832)   # the 14B pair's 480p, 33 of its 81 frames
BOUNDARY = 0.875  # the Wan2.2 pair's switch: the high-noise expert serves t >= 0.875
# the pair path's forwards by expert: on the "simple" ladder (shift 5) of 20
# steps the first 9 have t >= 0.875: 9 * 3 CFG pairs; the low expert 10 * 3 + 1
EXPERT_FORWARDS = {"high": 2 * 9 * (VIDEO_THINK + 1),
                   "low": 2 * (10 * (VIDEO_THINK + 1) + EARLY_STOP)}
# the Z-Image path: the Z_image_Inpaint workflow's 9 steps, cfg 1
Z_STEPS = 9
Z_FORWARDS = (Z_STEPS - EARLY_STOP) * (THINK + 1) + EARLY_STOP  # 49
# the small Qwen-Image pipeline check: 2 steps, cfg 1
SMALL_QWEN_FORWARDS = (2 - EARLY_STOP) * (THINK + 1) + EARLY_STOP  # 7
FORWARDS = {"sdxl": 2 * PAIRS, "pixel": 2 * PAIRS, "flux": PAIRS,  # CFG 5 seq. / cfg 1
            "video": 2 * VIDEO_PAIRS, "pair": 2 * VIDEO_PAIRS,     # CFG 5 sequential
            "pipeline": 2 * PAIRS, "sd15": 2 * PAIRS,
            "zimage": Z_FORWARDS, "qwen_edit": PAIRS, "qwen_small": SMALL_QWEN_FORWARDS,
            "sd35": 2 * PAIRS, "hidream": PAIRS, "hyvideo": PAIRS,  # CFG 4.5 seq. / cfg 1
            "controlnet": 2 * PAIRS}  # CFG 5 sequential
# the serving path: two batches of 2 lanes (one co-batched pair, one lone
# request padded with its lane 0), batched CFG: one UNet forward at batch 4
# a CFG pair
SERVE_BATCHES = 2
FORWARDS["serve"] = SERVE_BATCHES * PAIRS
# the parallel path (phase 22, a world of one): 2 euler steps x 2 think, cfg 1
# (4 steps before phase 24 needed the time)
SP_STEPS, SP_THINK = 2, 2
FORWARDS["parallel"] = (SP_STEPS - EARLY_STOP) * (SP_THINK + 1) + EARLY_STOP  # 4
# the tensor-parallel path (phase 24b): two ranks on the one card, each 4
# euler steps x 2 think, cfg 1 over its tensor-2 shard of SDXL: the two
# ranks' forwards together
TP_RANKS, TP_STEPS = 2, 4
TP_RANK_FORWARDS = (TP_STEPS - EARLY_STOP) * (SP_THINK + 1) + EARLY_STOP  # 10
FORWARDS["tp"] = TP_RANKS * TP_RANK_FORWARDS  # 20
# the FLUX.2 path (phase 8b): the benchmark cell's 1248x832 with its
# reference latent, euler "simple" 4 steps x 2 think, cfg 1
FLUX2_STEPS = 4
FLUX2_LATENT = (1, 32, 104, 156)
FLUX2_TXT, FLUX2_REF = 512, 4056
FORWARDS["flux2"] = (FLUX2_STEPS - EARLY_STOP) * (VIDEO_THINK + 1) + EARLY_STOP  # 10
PER_FORWARD = {  # kernel launches per model forward
    "sdxl": {"flash_attention": 70, "layernorm": 210, "rmsnorm": 0},
    # 19 double + 38 single blocks; adaLN norms 4 + 1 per block + 1 final;
    # QKNorm with RoPE in its epilogue 4 per double block, 2 per single block
    "flux": {"flash_attention": 57, "layernorm": 115, "rmsnorm": 0, "rmsnorm_rope": 152},
    # 30 blocks: self-attention and the cross-attention over the 512 text
    # tokens (S >= 1,024 queries: the kernel takes Sk != S), two a block;
    # norm1, norm2, norm3 + the head's norm; the cross q RMS norm, and the
    # self q and k with RoPE in the epilogue
    "video": {"flash_attention": 60, "layernorm": 91, "rmsnorm": 30, "rmsnorm_rope": 60},
    "pair": {"flash_attention": 80, "layernorm": 121, "rmsnorm": 40,  # 40 blocks
             "rmsnorm_rope": 80},
}
# the seq-parallel TI2V-5B: ring self-attention (plain fp32, no kernel), the
# cross-attention through the kernel (a rank's 7,920 queries over the 512
# text tokens), the video path's norms, and the cross norm_k of each block
# in the forward (no hoist on the parallel path)
PER_FORWARD["parallel"] = {"flash_attention": 30, "layernorm": 91, "rmsnorm": 60,
                           "rmsnorm_rope": 60}
PER_FORWARD["pixel"] = PER_FORWARD["pipeline"] = PER_FORWARD["serve"] = PER_FORWARD["sdxl"]
# of each path's flash_attention launches, the cross-attention ones
# (`telemetry.summary()["cross_launches"]`): Wan's, one a block; none
# elsewhere (the UNet's 77-token cross-attention stays plain)
CROSS_PER_FORWARD = {"video": 30, "pair": 40, "parallel": 30}
# a rank's tensor-2 SDXL: every block on its half of the heads (10 and 20
# heads: 5 and 10), the blocks' LayerNorms whole
PER_FORWARD["tp"] = PER_FORWARD["sdxl"]
# SDXL with its ControlNet: the UNet's 70 self-attention calls and 210
# LayerNorms, and the ControlNet encoder's transformer_depth (0, 2, 10) and
# middle 10: 4 blocks at S = 4,096 and 30 at S = 1,024, 3 LayerNorms each
PER_FORWARD["controlnet"] = {"flash_attention": 104, "layernorm": 312, "rmsnorm": 0}
# FLUX.2 [dev]: 8 double + 48 single blocks at S = 8,624 (512 text, 4,056
# target and 4,056 reference tokens); the adaLN pre-norms 4 a double block,
# 1 a single one and the final one; QKNorm with RoPE 4 a double block, 2 a
# single one
PER_FORWARD["flux2"] = {"flash_attention": 56, "layernorm": 81, "rmsnorm": 0,
                        "rmsnorm_rope": 128}
# SD1.5 at 512^2: 16 transformer blocks, 3 LayerNorms each; its head dims
# (40, 80, 160) are not multiples of 64, so its attention stays plain, as
# the JAX package leaves it to XLA
PER_FORWARD["sd15"] = {"flash_attention": 0, "layernorm": 48, "rmsnorm": 0}
# Z-Image: the 2 noise-refiner blocks (S = 4,096) and the 30 main layers
# (S = n_txt + 4,096) take the kernel, the 2 context-refiner blocks' few
# text tokens stay plain; RMS: 6 a block (4 sandwich norms, q and k) in 34
# blocks, cap_norm and norm_final; the final LayerNorm is plain, as in JAX
PER_FORWARD["zimage"] = {"flash_attention": 32, "layernorm": 0, "rmsnorm": 206}
# Qwen-Image: 60 double blocks (S = n_txt + 8,192 with the reference
# tokens); adaLN norms 4 a block + the final one, txt_norm, QKNorm with RoPE
# 4 a block
PER_FORWARD["qwen_edit"] = {"flash_attention": 60, "layernorm": 241, "rmsnorm": 1,
                            "rmsnorm_rope": 240}
PER_FORWARD["qwen_small"] = {"flash_attention": 2, "layernorm": 9, "rmsnorm": 1,  # 2 blocks
                             "rmsnorm_rope": 8}
# SD3.5-Large: 38 joint blocks (S = 231 + 4,096); ln_q and ln_k of both
# streams, 4 a block; its affine-free LayerNorms are plain torch, as in JAX
PER_FORWARD["sd35"] = {"flash_attention": 38, "layernorm": 0, "rmsnorm": 152}
# HiDream-I1: 16 double + 32 single blocks; the full-width q and k RMS norms
# of each stream, 4 a double block and 2 a single one; LayerNorms plain
PER_FORWARD["hidream"] = {"flash_attention": 48, "layernorm": 0, "rmsnorm": 128}
# HunyuanVideo: 20 double + 40 single blocks; adaLN LN -> fp32 4 a double
# block, 1 a single one and the final one, the token refiner's affine norm1
# and norm2 in its 2 blocks; per-head q and k RMS 4 a double block, 2 a single
PER_FORWARD["hyvideo"] = {"flash_attention": 60, "layernorm": 125, "rmsnorm": 160}
PER_RUN = {  # per run: fused half on warm iterations, finish on every one; the
    # VAE's mid attention once in the encode and once in the decode; the
    # Wan cross norm_k of every block in each of the two conds' precompute
    # (the pair's hoists both experts': 2 x 2 x 40)
    "sdxl": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 0},
    "pixel": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2},
    "flux": {"fused_half_step": (STEPS - EARLY_STOP) * (THINK - 1),
             "fused_finish": (STEPS - EARLY_STOP) * THINK, "wide_attention": 0},
    "video": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2, "rmsnorm": 60},
    "pair": {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2, "rmsnorm": 160},
}
PER_RUN["pipeline"] = PER_RUN["sd15"] = PER_RUN["zimage"] = PER_RUN["qwen_small"] = \
    PER_RUN["pixel"]
# edit_image encodes the source twice (the reference tokens and the latent)
PER_RUN["qwen_edit"] = {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 3}
PER_RUN["sd35"] = PER_RUN["pixel"]  # the SD3 VAE's encode and decode
PER_RUN["hidream"] = PER_RUN["hyvideo"] = PER_RUN["controlnet"] = PER_RUN["parallel"] = \
    PER_RUN["tp"] = PER_RUN["flux2"] = PER_RUN["sdxl"]  # latent paths
# each serving batch: the SDXL VAE's encode and decode of the batch
PER_RUN["serve"] = {"fused_half_step": 0, "fused_finish": 0, "wide_attention": 2 * SERVE_BATCHES}
BLEND = 9  # MaskBlend overlap of the pixel and video paths
SPLASH = "lanpaint_tpu/models/layers.py:131 (_splash_kernel)"
# the JAX package's cross-attention: attention_bshd(impl="auto") -> XLA
XLA_CROSS = "lanpaint_tpu/models/layers.py:176 (attention_bshd, XLA)"
# (shape (B, S, H, D) or (B, S, H, D, Sk) for k and v of Sk rows, calls per
# forward by path, TPU kernel or call it replaces)
ATTN_SHAPES = [
    ((1, 4096, 10, 64), {"sdxl": 10, "pixel": 10, "pipeline": 10, "controlnet": 14}, SPLASH),
    ((1, 1024, 20, 64), {"sdxl": 60, "pixel": 60, "pipeline": 60, "controlnet": 90},
     "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((1, 4096, 5, 64), {"tp": 10}, SPLASH),  # a tensor-2 rank's SDXL heads
    ((1, 1024, 10, 64), {"tp": 60}, "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((1, 4608, 12, 128), {}, SPLASH),  # Flux-dev's at tensor 2
    ((4, 4096, 10, 64), {"serve": 10}, SPLASH),  # batched CFG over two lanes
    ((4, 1024, 20, 64), {"serve": 60}, "lanpaint_tpu/models/layers.py:238 (flash_attention)"),
    ((1, 9216, 5, 64), {}, SPLASH),   # SD2.1-v at 768^2: the 96x96 level
    ((1, 2304, 10, 64), {}, SPLASH),  # and the 48x48 level
    ((1, 4608, 24, 128), {"flux": 57}, SPLASH),
    ((1, 7920, 24, 128), {"video": 30}, SPLASH),  # TI2V-5B at 704x1280 x 33 frames
    ((1, 14040, 40, 128), {"pair": 40}, SPLASH),  # T2V-A14B at 480x832 x 33 frames
    ((1, 8624, 48, 128), {"flux2": 56}, SPLASH),  # FLUX.2 at 1248x832, linear1's views
    ((2, 1000, 4, 64), {}, None),
    ((2, 1000, 4, 128), {}, None),
    # Wan's cross-attention over its 512 text tokens: the benchmark's
    # batch-2 CFG, TI2V-5B (sequential CFG here; the seq-parallel rank's
    # too) and T2V-A14B; q contiguous, k and v views of the hoisted cache
    ((2, 7920, 24, 128, 512), {}, XLA_CROSS),
    ((1, 7920, 24, 128, 512), {"video": 30, "parallel": 30}, XLA_CROSS),
    ((1, 14040, 40, 128, 512), {"pair": 40}, XLA_CROSS),
    # a ragged key run of 77 (CLIP's text length): SDXL's 4,096-level cross
    # shape at batch-2 CFG (the UNet's stays plain), and ragged S and Sk
    ((2, 4096, 10, 64, 77), {}, XLA_CROSS),
    ((2, 1000, 4, 64, 77), {}, None),
    ((2, 1000, 4, 128, 77), {}, None),
]
# the VAEs' mid attention (one head of 512, 640 or 384): (shape, calls per
# run by path, TPU call site)
SPLASH_VAE = SPLASH + " via lanpaint_tpu/models/vae.py:81"
SPLASH_VIDEO = SPLASH + " via lanpaint_tpu/models/video_vae.py:159"
WIDE_SHAPES = [
    ((1, 16384, 1, 512), {"pixel": 2, "pipeline": 2, "zimage": 2},
     SPLASH_VAE),  # 1024^2: encode, decode
    ((2, 16384, 1, 512), {"serve": 2 * SERVE_BATCHES}, SPLASH_VAE),  # a serving batch's
    ((1, 4096, 1, 512), {"sd15": 2}, SPLASH_VAE),    # 512^2
    ((1, 4000, 1, 512), {}, SPLASH_VAE),             # a ragged S
    ((9, 3520, 1, 640), {"video": 2}, SPLASH_VIDEO),  # Wan2.2 VAE, 704x1280 x 33 frames
    ((9, 6240, 1, 384), {"pair": 2}, SPLASH_VIDEO),  # Wan2.1 VAE, 480x832 x 33 frames
    ((2, 1100, 1, 640), {}, SPLASH_VIDEO),           # a ragged S
    ((2, 1100, 1, 384), {}, SPLASH_VIDEO),
]
# (shape, mode, calls per forward by path[, calls per run by path]); a 4D
# rmsnorm input is the strided q/k view of a fused projection, as the DiT
# hands it over, a 3D one a dense projection's output (Wan's full-width norm)
NORM_SHAPES = [
    ((1, 4096, 640), "layernorm", {"sdxl": 30, "pixel": 30, "pipeline": 30, "controlnet": 42,
                                   "tp": 30}),
    ((1, 1024, 1280), "layernorm", {"sdxl": 180, "pixel": 180, "pipeline": 180,
                                    "controlnet": 270, "tp": 180}),
    ((4, 4096, 640), "layernorm", {"serve": 30}),  # batched CFG over two lanes
    ((4, 1024, 1280), "layernorm", {"serve": 180}),
    ((1, 4096, 320), "layernorm", {"sd15": 15}),  # SD1.5 at 512^2, by level
    ((1, 1024, 640), "layernorm", {"sd15": 15}),
    ((1, 256, 1280), "layernorm", {"sd15": 15}),
    ((1, 64, 1280), "layernorm", {"sd15": 3}),    # the middle block
    ((1, 4096, 3072), "layernorm_na", {"flux": 39}),
    ((1, 512, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4608, 3072), "layernorm_na", {"flux": 38}),
    ((1, 4096, 24, 128), "rmsnorm_rope", {"flux": 38}),
    ((1, 512, 24, 128), "rmsnorm_rope", {"flux": 38}),
    ((1, 4608, 24, 128), "rmsnorm_rope", {"flux": 76}),
    ((1, 4608, 12, 128), "rmsnorm_rope", {}),  # Flux-dev's linear1 q / k at tensor 2
    ((1, 7920, 3072), "layernorm_na", {"video": 61, "parallel": 61}),
    ((1, 7920, 3072), "layernorm", {"video": 30, "parallel": 30}),
    ((1, 7920, 3072), "rmsnorm", {"video": 30, "parallel": 30}),
    ((1, 7920, 3072), "rmsnorm_rope", {"video": 60, "parallel": 60}),
    ((2, 7920, 3072), "rmsnorm_rope", {}),  # the benchmark's video cell: batched CFG
    ((1, 512, 3072), "rmsnorm", {"parallel": 30}, {"video": 60}),
    ((1, 14040, 5120), "layernorm_na", {"pair": 81}),
    ((1, 14040, 5120), "layernorm", {"pair": 40}),
    ((1, 14040, 5120), "rmsnorm", {"pair": 40}),
    ((1, 14040, 5120), "rmsnorm_rope", {"pair": 80}),
    ((1, 512, 5120), "rmsnorm", {}, {"pair": 160}),
    # FLUX.2 [dev]: the double blocks' image stream (target and reference
    # tokens) and text stream, the single blocks' joint sequence, the final
    # layer on the target's tokens; q / k as strided views of the double
    # blocks' qkv (3 x 6,144 wide) and of linear1 (55,296 wide)
    ((1, 8112, 6144), "layernorm_na", {"flux2": 16}),
    ((1, 512, 6144), "layernorm_na", {"flux2": 16}),
    ((1, 8624, 6144), "layernorm_na", {"flux2": 48}),
    ((1, 4056, 6144), "layernorm_na", {"flux2": 1}),
    ((1, 8112, 48, 128), "rmsnorm_rope", {"flux2": 16}),
    ((1, 512, 48, 128), "rmsnorm_rope", {"flux2": 16}),
    ((1, 8624, 48, 128), "rmsnorm_rope", {"flux2": 96}),
]
# the fused projection's row width where q, k and v share it with more
# columns: FLUX.2's single block reads them from linear1 (3 x 6,144 + 2 x
# 18,432); any other (B, S, H, D) from a (B, S, 3 * H * D) projection
QKV_WIDTH = {(1, 8624, 48, 128): 3 * 6144 + 2 * 18432}
# a 4D RoPE row's table, by shape: (first row, rows, axes, theta) of the
# joint sequence's table, FLUX.2's four axes at theta 2,000 ([text; image;
# reference]: the double block's text and image slices, the single block's
# whole); any other shape Flux's three axes (`rope_case`)
FLUX2_ROPE = {(1, 512, 48, 128): (0, 8624), (1, 8112, 48, 128): (512, 8624),
              (1, 8624, 48, 128): (0, 8624)}
# SDXL, Flux, ragged: whole quads a row, and M % 4 != 0 (quads straddle rows)
FUSED_SHAPES = [(1, 4 * 128 * 128), (1, 16 * 128 * 128), (2, 1000), (3, 1001)]
ATTN_TOL = dict(max_abs=2e-2, rel_l2=1e-2)
NORM_TOL = dict(atol=2e-2, rtol=1e-2)
FUSED_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_fused.py's
# noise_mult=1 against the plain version fed the CPU twin's normals: the
# card's logf / sqrtf / sincospif against float64 ones rounded to fp32 (a
# few ulp of a normal, times coefficients <= ~1) and FMA contraction
FUSED_NOISE_TOL = dict(rtol=1e-5, atol=1e-5)
# One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): the
# bound of a call is the larger of its bytes over PEAK_BYTES and its
# operations over the peak of their type.
PEAK_BF16 = 989e12    # tensor-core FLOP/s, bf16
PEAK_FP32 = 67e12     # FLOP/s outside the tensor cores, fp32
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# fp32 operations per element, counted from each kernel's body: the row
# norm's LayerNorm (x^2, two sums, centre, scale, affine) and RMS mode; the
# fused think-step kernels' SHO/OU mix and Box-Muller draws (ops/fused.py)
NORM_OPS = {"layernorm": 8, "layernorm_na": 6, "rmsnorm": 5, "rmsnorm_fp32": 5,
            "rmsnorm_rope": 8}  # the RMS mode's 5 and the rotation's 2 mul + 1 add
FUSED_OPS = 60
# bytes per element the fused kernels must move: half step 4 fp32 reads and
# 3 writes, warm finish 6 reads (x_half, v_half, x_half_od, c_old, c_new,
# mask; not x_in) and 2 writes, cold finish 3 reads and 2 writes
FUSED_BYTES = {"fused_half_step": 28, "fused_finish warm": 32, "fused_finish cold": 20}


def say(line: str) -> None:
    print(line, flush=True)


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, n: int = 10) -> float:
    """Device time per call, in us: CUDA events around n back-to-back calls
    that the host queues while the card runs a ~55 ms sleep kernel, so the
    host's launch work overlaps the sleep and not the timed calls (kernel
    time plus the gaps between the call's kernels).  If the host could not
    queue them all within the sleep (the launch queue holds ~1,000
    kernels, and a plain version launches ~50-100 a call), n is halved."""
    fn()
    torch.cuda.synchronize()
    while True:
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(100_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if host_ms < 0.8 * before.elapsed_time(start):  # queued within the sleep
            return 1e3 * start.elapsed_time(end) / n
        if n == 1:
            raise AssertionError("the host could not queue one call within the sleep")
        n //= 2


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def bound(n_bytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes over the memory rate and its operations over `peak`."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * ops / peak
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def timed_row(kernel, plain, err, calls, *, bounds, library=None, library_name=None,
              run_calls=None, reps: int = 20, device: bool = True, **extra):
    """Times of the kernel, its plain version and (where one PyTorch call
    computes the same function) that call: per launch including the host's
    work (ms, the median of `reps`) and, unless `device` is false, on the
    device (us; else None, not measured).  `calls`: launches per forward by
    path; `run_calls`: launches per run by path."""
    us = device_us if device else (lambda fn: None)
    ms = lambda fn: median_ms(fn, n=reps, warmup=min(3, reps))  # noqa: E731
    r = dict(err=err, calls=calls, run_calls=run_calls or {}, ms=ms(kernel),
             plain_ms=ms(plain), us=us(kernel), plain_us=us(plain),
             library=library_name, library_ms=None, library_us=None, **bounds, **extra)
    if library is not None:
        r.update(library_ms=ms(library), library_us=us(library))
    return r


def row_text(r) -> str:
    lib = ("" if r["library_ms"] is None else
           f" library {r['library_ms']:.4f} ms ({r['library_us']:.1f} us device, "
           f"{r['library']})")
    return (f"kernel {r['ms']:.4f} ms ({r['us']:.1f} us device) plain {r['plain_ms']:.4f} ms "
            f"({r['plain_us']:.1f} us device){lib} bound {1e3 * r['bound_ms']:.1f} us "
            f"({r['bound_by']})")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    return smi


# kernel instantiations each CUDA library must hold: the D <= 128 attention
# two per head dim (a block a query tile, and persistent for short key
# runs), the wide attention one per head dim, the row norm one per (x dtype,
# out dtype, vectors a thread) of fp32 / bf16 and 1, 2, 4, 8 and with the
# RoPE epilogue one per (dtype, vectors a thread), the fused think step one
# per (phase, quads a thread) of half / warm / cold and 1, 2
INSTANTIATIONS = {"attention": 2 * len(attention.SUPPORTED_HEAD_DIMS),
                  "wide_attention": len(attention.WIDE_HEAD_DIMS), "row_norm": 2 * 2 * 4 + 2 * 4,
                  "fused": 3 * 2}
WGMMA_LIBRARIES = ("attention", "wide_attention")


def phase_build() -> None:
    """One nvcc (a subprocess) per CUDA source, all started together.  No
    instantiation may spill (the ptxas logs are read); each attention
    kernel's `setmaxnreg` must not be ignored, and the SASS of each of its
    instantiations must hold wgmma (HGMMA) and TMA loads (UTMALDG)."""
    def nvcc(name):
        t0 = time.perf_counter()
        lib = cuda_build.build_library(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        jobs = {name: pool.submit(nvcc, name) for name in cuda_build.SOURCES}
        built = {name: job.result() for name, job in jobs.items()}
    for name, (lib, t_nvcc) in built.items():
        cuda_build.entry(name)
        log = lib.with_suffix(".log").read_text()
        kernels = ptxas_counts(log)
        say(f"phase 2 build: nvcc {t_nvcc:.1f} s ({lib.name}); ptxas: "
            + " / ".join(f"{k}: {v}" for k, v in kernels.items()))
        if len(kernels) != INSTANTIATIONS[name] or any(
                "0 bytes spill stores" not in v or "0 bytes spill loads" not in v
                for v in kernels.values()):
            raise AssertionError(f"an instantiation of {name} spills registers, or "
                                 f"{len(kernels)} instantiations (want {INSTANTIATIONS[name]})")
        if name in WGMMA_LIBRARIES:
            if "setmaxnreg ignored" in log:
                raise AssertionError(f"ptxas ignored the {name} kernel's setmaxnreg")
            sass = sass_counts(lib)
            say(f"phase 2 build: SASS of the {name} kernel (cuobjdump -sass): "
                + " / ".join(f"{k}: {v['HGMMA']} HGMMA, {v['UTMALDG']} UTMALDG"
                             for k, v in sass.items()))
            if len(sass) != INSTANTIATIONS[name] or not all(min(v.values())
                                                            for v in sass.values()):
                raise AssertionError(f"an instantiation of the {name} kernel lacks wgmma "
                                     "(HGMMA) or TMA loads (UTMALDG) in its SASS")


def _instantiation(mangled: str) -> str:
    """A kernel instantiation named by its template arguments: D for the
    attention kernels (and "persistent" for the D <= 128 kernel's short-key
    instantiation), the mangled (x dtype, out dtype, vectors) for the row
    norm, (phase, quads a thread) for the fused think step."""
    if "row_norm_kernelI" in mangled:
        return "row_norm<" + mangled.split("row_norm_kernelI", 1)[1].split("EEv", 1)[0] + ">"
    args = re.findall(r"Li(\d+)E", mangled)
    if "fused_think_kernelI" in mangled:
        return f"fused<{('half', 'warm', 'cold')[int(args[0])]}, {args[1]} quads>"
    if not args:
        return mangled
    return "D=" + "x".join(args) + (" persistent" if "Lb1E" in mangled else "")


def sass_counts(lib) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA tensor load) instructions per kernel
    instantiation in a library's SASS, from the toolkit's cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = _instantiation(ln.split("Function :", 1)[1].strip())
            out[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in out[name]:
                out[name][op] += bool(re.search(rf"\b{op}\b", ln))
    return out


def ptxas_counts(log: str) -> dict:
    """ptxas -v's registers and spills per kernel instantiation, named by
    its template arguments (D, or D x row groups)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = _instantiation(ln.split("'")[1])
            out[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            part = ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip()
            out[name] = (out[name] + ", " + part).strip(", ")
    return out


def _qkv_views(b, s, h, d, gen):
    """q, k, v as the main paths hand them over: strided views of one fused
    projection (B, S, 3 * H * D, or `QKV_WIDTH`'s width)."""
    width = QKV_WIDTH.get((b, s, h, d), 3 * h * d)
    qkv = torch.randn((b, s, width), device="cuda", generator=gen).to(torch.bfloat16)
    return [qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3)]


def _cross_views(b, s, sk, h, d, gen):
    """q, k, v as Wan's cross-attention hands them over: q a contiguous
    (B, S, H, D) norm output, k and v block 1's (B, Sk, H, D) views of a
    hoisted (B, 2, Sk, H * D) cache."""
    q = torch.randn((b, s, h, d), device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((b, 2, sk, h * d), device="cuda", generator=gen).to(torch.bfloat16)
            [:, 1].unflatten(-1, (h, d)) for _ in range(2))
    return q, k, v


def _kernel_attention(gen, kernel=attention.flash_attention, shapes=ATTN_SHAPES,
                      per_run=False) -> list:
    """Each shape through `kernel` against `attention_ref` in fp32, then
    timed against `attention_ref` on the same bf16 inputs."""
    rows = []
    for shape, calls, *replaces in shapes:
        b, s, h, d = shape[:4]
        sk = shape[4] if len(shape) > 4 else s
        flops, n_bytes = 4 * b * h * s * sk * d, 4 * b * h * d * (s + sk)
        if sk != s:
            q, k, v = _cross_views(b, s, sk, h, d, gen)
        else:
            q, k, v = _qkv_views(b, s, h, d, gen)
            if s % 8:  # a ragged S: contiguous inputs
                q, k, v = (t.contiguous() for t in (q, k, v))
        out = kernel(q, k, v)
        torch.cuda.synchronize()
        want = _plain_attention(q.float(), k.float(), v.float())
        err = float((out.float() - want).abs().max())
        rel = rel_l2(out.float(), want)
        del want
        ok = err <= ATTN_TOL["max_abs"] and rel <= ATTN_TOL["rel_l2"]
        if not ok:
            raise AssertionError(f"{kernel.__name__} {shape} disagrees with attention_ref: "
                                 f"max abs {err}, rel L2 {rel}, limits {ATTN_TOL}")
        backends = _sdpa_backends(q, k, v)
        r = timed_row(lambda: kernel(q, k, v), lambda: _plain_attention(q, k, v), err,
                      {} if per_run else calls, run_calls=calls if per_run else None,
                      bounds=bound(n_bytes, flops, PEAK_BF16),
                      library=lambda: _sdpa(q, k, v),
                      library_name="scaled_dot_product_attention, backends that take it: "
                                   + ("/".join(backends) or "math only"),
                      shape=shape[:4], kv_len=sk, replaces=replaces[0] if replaces else None)
        label = shape[:4] if sk == s else f"{shape[:4]} x Sk {sk}"
        say(f"phase 3 kernels: {kernel.__name__} {label} max_abs_err {err:.3g} rel_l2 "
            f"{rel:.3g} {row_text(r)}, {flops / r['us'] / 1e6:.1f} TFLOP/s = "
            f"{100 * 1e3 * r['bound_ms'] / r['us']:.1f}% of the bound ok")
        rows.append(r)
    return rows


def _plain_attention(q, k, v):
    """`attention.attention_ref` over groups of heads whose fp32 logits stay
    under 8 GB (all heads at once below that): the pair's (1, 14040, 40,
    128) would hold 31.5 GB of logits three times over at once."""
    b, s, h, _ = q.shape
    group = max(1, int(8e9 // (4 * b * s * k.shape[1])))
    if group >= h:
        return attention.attention_ref(q, k, v)
    return torch.cat([attention.attention_ref(*(t[:, :, i:i + group] for t in (q, k, v)))
                      for i in range(0, h, group)], dim=2)


def _sdpa(q, k, v):
    """The PyTorch call computing the same attention (yardstick only)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2)).transpose(1, 2)


def _sdpa_backends(q, k, v) -> list:
    """The fused SDPA backends that accept this call (flash stops at D =
    256); with none, PyTorch's default call takes its math path."""
    ok = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns why
                _sdpa(q, k, v)
            ok.append(backend.name.lower())
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return ok


def rope_case(shape, gen):
    """(x, table) of an RMS norm with the RoPE epilogue at `shape`, as the
    models hand it over: a 4D (B, S, H, 128) q is a strided third of a fused
    projection (Flux's QKNorm) whose rows of the table are, at S = 512 and
    4,096, the txt and img slices of a double block's 4,608-token table
    (FLUX.2's: `FLUX2_ROPE`); a 3D (B, S, C) one is Wan's dense full-width
    rows."""
    b, s = shape[:2]
    theta = 10000.0
    if tuple(shape) in FLUX2_ROPE:
        x = _qkv_views(*shape, gen)[0]
        (start, total), axes, theta = FLUX2_ROPE[tuple(shape)], (32, 32, 32, 32), 2000.0
    elif len(shape) == 4:
        x = _qkv_views(*shape, gen)[0]
        start, total = {512: (0, 4608), 4096: (512, 4608)}.get(s, (0, s))
        axes = (16, 56, 56)
    else:
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        start, total, axes = 0, s, (44, 42, 42)
    ids = torch.randint(0, 128, (b, total, len(axes)), device="cuda", generator=gen)
    return x, layers.rope_freqs(ids, axes, theta)[:, start:start + s]


def _kernel_norms(gen) -> list:
    rows = []
    for shape, mode, calls, *run_calls in NORM_SHAPES:
        c = shape[-1]
        library = freqs = None
        if mode == "rmsnorm_rope":  # against rmsnorm + apply_rope on the card, bit for bit
            x, freqs = rope_case(shape, gen)
            g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
            kernel = lambda: norms.rmsnorm_rope(x, g, 1e-6, freqs, 128)  # noqa: E731
            plain = lambda: norms.rmsnorm_rope_ref(x, g, 1e-6, freqs, 128)  # noqa: E731
            library = lambda: norms.rope_rows(norms.rmsnorm(x, g), freqs, 128)  # noqa: E731
            if not torch.equal(kernel(), library()):
                raise AssertionError(f"rmsnorm_rope {shape} differs from rmsnorm + apply_rope")
        elif mode.startswith("rmsnorm"):  # 4D: a strided q view, as QKNorm gets it
            x = (_qkv_views(*shape, gen)[0] if len(shape) == 4 else
                 torch.randn(shape, device="cuda", generator=gen))
            # fp32 rows (Z-Image's cap_norm on the text states) or bf16
            x = x if mode == "rmsnorm_fp32" else x.to(torch.bfloat16)
            g = (1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
            kernel, plain = (lambda: norms.rmsnorm(x, g)), (lambda: norms.rmsnorm_ref(x, g))
            g_lib = g.to(x.dtype)  # F.rms_norm takes the weight in x's dtype
            library = lambda: F.rms_norm(x, (c,), g_lib, eps=1e-6)  # noqa: E731
        else:
            x = (torch.randn(shape, device="cuda", generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
            g = beta = None
            out_dtype = torch.float32
            if mode == "layernorm":
                g = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
                beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
                out_dtype = None
            kw = dict(eps=1e-6, out_dtype=out_dtype)
            kernel = lambda: norms.layernorm(x, g, beta, **kw)  # noqa: E731
            plain = lambda: norms.layernorm_ref(x, g, beta, **kw)  # noqa: E731
            if mode == "layernorm":  # F.layer_norm takes the weights in x's dtype
                gb, bb = g.to(x.dtype), beta.to(x.dtype)
                library = lambda: F.layer_norm(x, (c,), gb, bb, eps=1e-6)  # noqa: E731
        out = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((out.float() - want.float()).abs().max())
        ok = out.dtype == want.dtype and torch.allclose(out.float(), want.float(), **NORM_TOL)
        if not ok:
            raise AssertionError(f"{mode} {shape} disagrees with its plain version: {err}")
        params = [p for p in (g, beta) if p is not None] if not mode.startswith("rmsnorm") \
            else [g]
        # the table as the kernel reads it: once a token, whatever its heads
        params += [] if freqs is None else [freqs]
        n_bytes = sum(t.numel() * t.element_size() for t in (x, out, *params))
        r = timed_row(kernel, plain, err, calls, run_calls=run_calls[0] if run_calls else None,
                      bounds=bound(n_bytes, NORM_OPS[mode] * x.numel(), PEAK_FP32),
                      library=library,
                      library_name={"layernorm": "F.layer_norm", "rmsnorm": "F.rms_norm",
                                    "rmsnorm_fp32": "F.rms_norm",
                                    "rmsnorm_rope": "rmsnorm + apply_rope"}.get(mode),
                      shape=shape, mode=mode)
        say(f"phase 3 kernels: {mode} {shape} {out.dtype} max_abs_err {err:.3g} {row_text(r)} ok")
        rows.append(r)
    return rows


def _fused_case(b, m, gen, sigma=0.6):
    tx, ty = (t.cuda() for t in fused.pack_branch_coeffs(
        LanPaintConfig(), unify_times(torch.full((b,), sigma), ModelKind.FLOW)))
    rnd = lambda scale=1.0: torch.randn((b, m), device="cuda", generator=gen) * scale  # noqa: E731
    x, v, c, c_new = rnd(), rnd(0.1), rnd(), rnd()
    mask = (torch.rand((b, m), device="cuda", generator=gen) > 0.5).float()
    return tx, ty, x, v, c, c_new, mask


def _fused_phases(tx, ty, nm, x, v, c, c_new, mask, seed, twin=False, offset=0):
    """(name, kernel outputs, plain outputs) of the three launches (the
    half step at launch 0, the finishes at 1, all at element `offset`); the
    finishes take the kernel half step's outputs on both sides.  The plain
    versions take zeros for normals, or with `twin` the kernel's own draw
    made on the CPU (`fused.philox_normals`)."""
    b, m = x.shape
    if twin:
        draws = [fused.philox_normals(seed, launch, b, m, offset).cuda() for launch in (0, 1)]
    else:
        draws = [torch.zeros((3, b, m), device="cuda")] * 2
    half = fused.fused_half_step(tx, ty, nm, x, v, c, mask, seed=seed, launch=0, offset=offset)
    half_ref = fused.fused_half_step_ref(tx, ty, nm, x, v, c, mask, *draws[0])
    out = [("half", half, half_ref)]
    for warm in (True, False):
        got = fused.fused_finish(tx, ty, nm, warm, x, *half, c, c_new, mask, seed=seed, launch=1,
                                 offset=offset)
        want = fused.fused_finish_ref(tx, ty, nm, warm, x, *half, c, c_new, mask, *draws[1])
        out.append(("warm finish" if warm else "cold finish", got, want))
    torch.cuda.synchronize()
    return out


def _offset_views(*arrays):
    """Copies of (B, M) tensors that start 4 bytes past a 16-byte boundary:
    contiguous, but the kernel must take its scalar path."""
    out = []
    for t in arrays:
        buf = torch.empty(t.numel() + 4, device=t.device, dtype=t.dtype)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


def _check_fused_draw(label, tx, ty, x, v, c, c_new, mask, seed, offset=0) -> None:
    """Each phase at noise_mult 1 (at element `offset`) against its plain
    version fed the kernel's draw (FUSED_NOISE_TOL)."""
    for name, got, want in _fused_phases(tx, ty, 1.0, x, v, c, c_new, mask, seed, twin=True,
                                         offset=offset):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.allclose(g, w, **FUSED_NOISE_TOL) for g, w in zip(got, want)):
            raise AssertionError(f"fused {name} {label} at noise_mult 1 disagrees with its plain "
                                 f"version fed philox_normals: max abs {err}, limits "
                                 f"{FUSED_NOISE_TOL}")
        say(f"phase 3 kernels: fused {name} {label} noise_mult 1 against the plain version fed "
            f"philox_normals max_abs_err {err:.3g} ok")


def _kernel_fused(gen) -> tuple:
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    half_rows, finish_rows = [], []
    # (a) noise_mult = 0 against the plain versions, with times
    for b, m in FUSED_SHAPES:
        tx, ty, x, v, c, c_new, mask = _fused_case(b, m, gen)
        errs = {}
        for name, got, want in _fused_phases(tx, ty, 0.0, x, v, c, c_new, mask, seed):
            errs[name] = err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if not all(torch.allclose(g, w, **FUSED_TOL) for g, w in zip(got, want)):
                raise AssertionError(f"fused {name} ({b}, {m}) disagrees with its plain "
                                     f"version: max abs {err}, limits {FUSED_TOL}")
            say(f"phase 3 kernels: fused {name} ({b}, {m}) noise_mult 0 max_abs_err {err:.3g} ok")
        _check_fused_draw(f"({b}, {m})", tx, ty, x, v, c, c_new, mask, seed)
        if b != 1:
            continue
        # times: each plain version draws its three normals as the kernel does
        normals = lambda: torch.randn((3, b, m), device="cuda").unbind(0)  # noqa: E731
        xh, vh, xho = fused.fused_half_step(tx, ty, 1.0, x, v, c, mask, seed=seed)
        cases = [  # (name, rows, kernel, plain, its noise_mult=0 error above)
            ("fused_half_step", half_rows,
             lambda: fused.fused_half_step(tx, ty, 1.0, x, v, c, mask, seed=seed),
             lambda: fused.fused_half_step_ref(tx, ty, 1.0, x, v, c, mask, *normals()),
             errs["half"]),
            ("fused_finish warm", finish_rows,
             lambda: fused.fused_finish(tx, ty, 1.0, True, x, xh, vh, xho, c, c_new, mask,
                                        seed=seed),
             lambda: fused.fused_finish_ref(tx, ty, 1.0, True, x, xh, vh, xho, c, c_new, mask,
                                            *normals()),
             errs["warm finish"]),
            ("fused_finish cold", finish_rows,
             lambda: fused.fused_finish(tx, ty, 1.0, False, x, None, None, None, None, c_new,
                                        mask, seed=seed),
             lambda: fused.fused_finish_ref(tx, ty, 1.0, False, x, None, None, None, None,
                                            c_new, mask, *normals()),
             errs["cold finish"]),
        ]
        # this shape's launches in a timed run: only the Flux path fuses, with
        # one cold finish per think loop and the rest warm
        path = "flux" if m == 16 * 128 * 128 else "sdxl"
        loops = STEPS - EARLY_STOP if path == "flux" else 0
        per_run = {"fused_half_step": loops * (THINK - 1),
                   "fused_finish warm": loops * (THINK - 1), "fused_finish cold": loops}
        for name, rows, kernel, plain, err in cases:
            r = timed_row(kernel, plain, err, {}, run_calls={path: per_run[name]},
                          bounds=bound(FUSED_BYTES[name] * b * m, FUSED_OPS * b * m, PEAK_FP32),
                          shape=(b, m), mode=name)
            say(f"phase 3 kernels: {name} ({b}, {m}) {row_text(r)} (plain draws its normals)")
            rows.append(r)

    # inputs 4 bytes off a 16-byte boundary: the scalar path
    tx, ty, *arrays = _fused_case(2, 1000, gen)
    _check_fused_draw("(2, 1000) unaligned", tx, ty, *_offset_views(*arrays), seed)
    # a data-parallel rank's view: its rows start at element rows.start * M
    # of the whole batch; 3 * 1001 is no multiple of 4 (two global quads a
    # view quad), 4 * 4096 is
    tx, ty, *arrays = _fused_case(2, 1001, gen)
    _check_fused_draw("(2, 1001) at element offset 3003", tx, ty, *arrays, seed, offset=3 * 1001)
    tx, ty, *arrays = _fused_case(1, 4096, gen)
    _check_fused_draw("(1, 4096) at element offset 16384", tx, ty, *arrays, seed,
                      offset=4 * 4096)

    # (b) a non-finite damped coefficient: the kernels select the OU branch
    tx, ty, x, v, c, c_new, mask = _fused_case(2, 1000, gen)
    tx[:, 0] = tx[:, fused.N_COEF] = math.inf
    for name, got, want in _fused_phases(tx, ty, 0.0, x, v, c, c_new, mask, seed):
        ok = all(torch.isfinite(g).all() and torch.allclose(g, w, **FUSED_TOL)
                 for g, w in zip(got, want))
        if name == "half":
            ok = ok and torch.equal(want[0], want[2])  # x_half is the overdamped step
        if not ok:
            raise AssertionError(f"fused {name}: the non-finite select disagrees")
    say("phase 3 kernels: fused half / warm / cold finish with a non-finite damped "
        "coefficient select the overdamped step like the plain versions ok")

    # (c) noise statistics at noise_mult = 1 from a zero state (x branch)
    b, m = 2, 1 << 19
    tx, ty, *_ = _fused_case(b, 8, gen, sigma=0.5)
    z = torch.zeros((b, m), device="cuda")
    xh, vh, _ = fused.fused_half_step(tx, ty, 1.0, z, z, z, z, seed=seed, launch=0)
    xf, _ = fused.fused_finish(tx, ty, 1.0, True, z, z, z, z, z, z, z, seed=seed, launch=1)
    l_yy, l_vy, l_vv = (float(tx[0, j]) for j in (4, 5, 6))
    n = b * m
    sd_v = math.hypot(l_vy, l_vv)

    def corr(p, q):
        return float(torch.corrcoef(torch.stack([p.flatten(), q.flatten()]))[0, 1])

    stats = dict(mean_x=float(xh.mean()), std_x=float(xh.std()), std_v=float(vh.std()),
                 corr_xv=corr(xh, vh), corr_launches=corr(xh, xf), corr_rows=corr(xh[0], xh[1]))
    ok = (abs(stats["mean_x"]) <= 4 * l_yy / math.sqrt(n)
          and abs(stats["std_x"] / l_yy - 1) <= 0.02 and abs(stats["std_v"] / sd_v - 1) <= 0.02
          and abs(stats["corr_xv"] - l_vy / sd_v) <= 0.01
          and abs(stats["corr_launches"]) < 0.01 and abs(stats["corr_rows"]) < 0.01)
    say(f"phase 3 kernels: fused noise statistics over {n} elements: "
        + " ".join(f"{k} {v:.5g}" for k, v in stats.items())
        + f" | want std_x {l_yy:.5g} std_v {sd_v:.5g} corr_xv {l_vy / sd_v:.5g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused kernels' noise statistics are off")

    # the non-model time of a think step, fused against plain
    for shape, kind in (((1, 4, 128, 128), ModelKind.EPS), ((1, 16, 128, 128), ModelKind.FLOW)):
        lat = torch.randn(shape, device="cuda", generator=gen)
        mask4 = torch.zeros(shape, device="cuda")
        mask4[..., :, :64] = 1.0
        x0 = torch.randn(shape, device="cuda", generator=gen)
        times = unify_times(torch.tensor([0.6 if kind is ModelKind.FLOW else 2.0]), kind)
        ms = {}
        for label in ("plain", "fused", "fused", "plain"):
            cfg = LanPaintConfig(n_steps=THINK, use_fused_kernels=label == "fused")
            g = torch.Generator(device="cuda").manual_seed(1)
            run = lambda: lanpaint_update(  # noqa: E731
                lambda xm, t: (x0, x0), lat, latent_image=lat, noise=lat, latent_mask=mask4,
                times=times, n_steps=THINK, config=cfg, kind=kind, generator=g)
            ms.setdefault(label, []).append(median_ms(run, n=10, warmup=2) / THINK)
        say(f"phase 3 kernels: think-step non-model time per iteration at {shape} "
            f"(a constant denoiser, {THINK} think steps, in turns plain/fused/fused/plain): "
            f"plain {' '.join(f'{t:.4f}' for t in ms['plain'])} ms, fused "
            f"{' '.join(f'{t:.4f}' for t in ms['fused'])} ms")
    return half_rows, finish_rows


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_rows = _kernel_attention(gen)
    wide_rows = _kernel_attention(gen, attention.wide_attention, WIDE_SHAPES, per_run=True)
    norm_rows = _kernel_norms(gen)
    half_rows, finish_rows = _kernel_fused(gen)
    return {"flash_attention": attn_rows, "wide_attention": wide_rows, "row_norm": norm_rows,
            "fused_half_step": half_rows, "fused_finish": finish_rows}


def _three_ways(build, cfg, seed):
    """One set of weights: (fp32 on the CPU, bf16 on the CPU, bf16 on the card)."""
    ref_den, ref_mod = build(dataclasses.replace(cfg, dtype=torch.float32), seed=seed,
                             name="small", device="cpu")
    state = ref_mod.state_dict()
    plain = build(cfg, state, name="small", device="cpu")
    card = build(cfg, state, device="cuda", name="small")
    return [(ref_den, ref_mod, "cpu"), (*plain, "cpu"), (*card, "cuda")]


def _small_inputs(latent_shape, steps):
    """latent, initial noise, a centre pixel mask and a think-noise feed of
    `steps` rows, from one CPU generator."""
    gen = torch.Generator().manual_seed(5)
    latent = torch.randn(latent_shape, generator=gen)
    noise = torch.randn(latent_shape, generator=gen)
    px = latent_shape[-1] * 8
    mask = torch.zeros((px, px))
    mask[px // 4:3 * px // 4, px // 4:3 * px // 4] = 1.0
    feed = torch.randn((steps, 2, 5) + tuple(latent_shape), generator=gen)
    return latent, noise, mask, feed


def _small_runs(models, sampler_kw, inputs, cond, sigmas) -> list:
    """A 4-step LanPaint run (2 think steps) of each model on its device,
    every one fed `inputs`: the repainted square of each result, on the CPU."""
    latent, noise, mask, feed = inputs
    q = latent.shape[-1] // 4
    runs = []
    for den, _, dev in models:
        sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=2), **sampler_kw)
        on_dev = [None if c is None else
                  {k: v.to(dev) if torch.is_tensor(v) else v for k, v in c.items()}
                  for c in cond]
        samples, _ = sam(latent=latent.to(dev), sigmas=sigmas, cond=on_dev[0],
                         uncond=on_dev[1], mask=mask.to(dev), noise=noise.to(dev),
                         noise_feed=feed.to(dev))
        runs.append(samples.cpu()[..., q:3 * q, q:3 * q])
    return runs


def _against_fp32(outs) -> tuple:
    """(card's, plain bf16 path's relative L2 error against the fp32 CPU
    reference, whether the card's is within twice the plain's + 1e-3 and
    finite) of the three ways' outputs."""
    plain, card = (rel_l2(out, outs[0]) for out in outs[1:])
    return card, plain, card <= 2 * plain + 1e-3 and bool(torch.isfinite(outs[2]).all())


def _small_reference(label, models, forward, sampler_kw, latent_shape, cond, sigmas):
    """The card's relative L2 error against the fp32 CPU reference must be
    no more than twice the plain bf16 path's, plus 1e-3, for one forward
    and for a 4-step LanPaint run with a shared think-noise feed."""
    counters = (("attention", attention.flash_attention), ("layernorm", norms.layernorm),
                ("rmsnorm", norms.rmsnorm), ("rmsnorm_rope", norms.rmsnorm_rope))
    before = {k: f.launches for k, f in counters}
    with torch.no_grad():
        fwd = [forward(mod, dev).cpu() for _, mod, dev in models]
    ran = {k: f.launches - before[k] for k, f in counters}
    runs = _small_runs(models, sampler_kw, _small_inputs(latent_shape, len(sigmas) - 1), cond,
                       sigmas)
    fwd_card, fwd_plain, fwd_ok = _against_fp32(fwd)
    run_card, run_plain, run_ok = _against_fp32(runs)
    ok = fwd_ok and run_ok
    say(f"{label}: rel_l2 against fp32 on the CPU (limit 2x the plain bf16 path's + 1e-3): "
        f"forward card {fwd_card:.3g} plain {fwd_plain:.3g}; 4-step LanPaint run card "
        f"{run_card:.3g} plain {run_plain:.3g}; card-forward launches {ran} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, ran


def _solver_noise(x, generator, step, slot):
    """Solver noise shared by the three ways: slot `slot` of step `step`
    from its own seeded CPU generator (samplers._noise_like's contract)."""
    gen = torch.Generator().manual_seed(1000 * step + slot)
    return torch.randn(tuple(x.shape), generator=gen).to(device=x.device, dtype=x.dtype)


def _small_solvers(models, cond, sigmas, latent_shape) -> None:
    """The 4-step LanPaint run of `_small_reference` (CFG 5 sequential) with
    each of the 22 solvers, the think-noise feed and the solver noise
    (`_solver_noise`) shared by the three ways: the card within twice the
    plain bf16 path's error against fp32 on the CPU, plus 1e-3."""
    inputs = _small_inputs(latent_shape, len(sigmas) - 1)
    noise_like, samplers._noise_like = samplers._noise_like, _solver_noise
    failed = []
    try:
        for name in samplers.SAMPLER_NAMES:
            card, plain, ok = _against_fp32(_small_runs(
                models, dict(cfg=5.0, sequential_cfg=True, sampler_name=name), inputs, cond,
                sigmas))
            say(f"phase 4 small UNet solver {name}: 4-step LanPaint run rel_l2 against fp32 on "
                f"the CPU card {card:.3g} plain {plain:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(name)
    finally:
        samplers._noise_like = noise_like
    if failed:
        raise AssertionError(f"solvers {failed} on the card are less accurate than the plain "
                             "path")


def _count_calls(den, counts, key):
    """Count `den`'s model calls under counts[key]."""
    apply = den.apply

    def counted(x, t, cond):
        counts[key] += 1
        return apply(x, t, cond)

    den.apply = counted


def _small_dual(models, cond, sigmas, latent_shape) -> None:
    """`zoo.dual_model_denoiser` over two small UNets (phase 4's, seed 3,
    for the positive branch and one of seed 4 for the negative) with
    sequential CFG 5 and `model_select` in the negative cond, three ways:
    the card within twice the plain path's error plus 1e-3, and on the card
    each model called once per CFG pair."""
    negatives = _three_ways(zoo.build_unet, SMALL_UNET, seed=4)
    counts = {"pos": 0, "neg": 0}
    _count_calls(models[2][0], counts, "pos")
    _count_calls(negatives[2][0], counts, "neg")
    duals = [(zoo.dual_model_denoiser(p[0], n[0]), None, p[2]) for p, n in zip(models, negatives)]
    cond = (cond[0], dict(cond[1], model_select=1.0))
    card, plain, ok = _against_fp32(_small_runs(
        duals, dict(cfg=5.0, sequential_cfg=True), _small_inputs(latent_shape, len(sigmas) - 1),
        cond, sigmas))
    pairs = (len(sigmas) - 2) * 3 + 1  # 2 think steps + the final denoise; outer early stop 1
    ok = ok and counts == {"pos": pairs, "neg": pairs}
    say(f"phase 4 small UNet dual_model_denoiser (seeds 3 and 4, sequential CFG 5): 4-step "
        f"LanPaint run rel_l2 against fp32 on the CPU card {card:.3g} plain {plain:.3g}; model "
        f"calls on the card {counts} (want {pairs} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dual-model pair on the card failed its check")


SMALL_UNET = unet.UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                             transformer_depth=(1, 1), transformer_depth_middle=1,
                             context_dim=64, head_dim=64)
SMALL_DIT = dataclasses.replace(dit.FLUX_DEV_CONFIG, hidden=256, num_heads=2, depth_double=2,
                                depth_single=2, context_dim=64, vec_dim=32)


def phase_small_unet() -> None:
    """bf16 rounding alone puts the plain path ~2e-2 from the reference
    (the CPU tests measure the same on the tiny UNet), and CFG 5 amplifies
    it in the run, so the limit follows the plain path."""
    models = _three_ways(zoo.build_unet, SMALL_UNET, seed=3)
    sigmas = calculate_sigmas(models[0][0].sigma_table, "karras", 4)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4, 32, 32), generator=gen)
    t = torch.tensor([420.0])
    ctx = torch.randn((1, 12, 64), generator=gen)
    cond = ({"context": torch.randn((1, 12, 64), generator=gen)},
            {"context": torch.randn((1, 12, 64), generator=gen)})
    ok, ran = _small_reference(
        "phase 4 small UNet reference", models,
        lambda mod, dev: mod(x.to(dev), t.to(dev), ctx.to(dev)),
        dict(cfg=5.0, sequential_cfg=True), (1, 4, 32, 32), cond, sigmas)
    if not (ok and ran["attention"] and ran["layernorm"]):
        raise AssertionError("the small UNet on the card is less accurate than the plain path "
                             "or did not go through the kernels")
    _small_solvers(models, cond, sigmas, (1, 4, 32, 32))
    _small_dual(models, cond, sigmas, (1, 4, 32, 32))


def phase_small_controlnet() -> None:
    """Phase 4's check on SMALL_UNET with a ControlNet (seed 3) at strength
    1: its zero convs and middle_block_out drawn at 0.2 (they start at zero,
    and the control would add nothing), a seeded (1, 3, 256, 256) hint in
    both conds; one forward and the 4-step LanPaint run (CFG 5 sequential),
    bf16 on the card against the same weights in fp32 on the CPU, beside the
    CPU's bf16 plain path."""
    ref, (ref_unet, ref_cn) = zoo.build_controlled_unet(
        dataclasses.replace(SMALL_UNET, dtype=torch.float32), device="cpu", seed=3, name="small")
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for conv in ref_cn.zero_convs():
            conv.weight.normal_(0.0, 0.2, generator=gen)
    states = (ref_unet.state_dict(), ref_cn.state_dict())
    models = [(ref, ref, "cpu")] + [
        (den, den, dev) for den, dev in
        ((zoo.build_controlled_unet(SMALL_UNET, *states, device=dev, name="small")[0], dev)
         for dev in ("cpu", "cuda"))]
    x = torch.randn((1, 4, 32, 32), generator=gen)
    hint = torch.rand((1, 3, 256, 256), generator=gen) * 2.0 - 1.0
    cond = tuple({"context": torch.randn((1, 12, 64), generator=gen), "hint": hint}
                 for _ in range(2))
    sigma = torch.tensor([3.0])
    with torch.no_grad():
        moved = rel_l2(ref.apply(x, sigma, cond[0]),
                       ref.apply(x, sigma, {"context": cond[0]["context"]}))
    ok, ran = _small_reference(
        f"phase 4b small controlled UNet reference (rel_l2 of the control's change to the "
        f"forward {moved:.3g})", models,
        lambda den, dev: den.apply(x.to(dev), sigma.to(dev),
                                   {k: v.to(dev) for k, v in cond[0].items()}),
        dict(cfg=5.0, sequential_cfg=True), (1, 4, 32, 32), cond,
        calculate_sigmas(ref.sigma_table, "karras", 4))
    if not (ok and moved > 0.05 and ran["attention"] and ran["layernorm"]):
        raise AssertionError("the small controlled UNet on the card is less accurate than the "
                             "plain path, the control did not act, or the kernels did not run")


def phase_small_dit() -> None:
    """A small MMDiT at head dim 128 (hidden 256, 2 heads, 2 + 2 blocks) on
    a 64x64 latent: 1,024 image and 16 text tokens, so its joint attention
    takes the kernel; cfg 1 as the Flux path."""
    models = _three_ways(zoo.build_dit, SMALL_DIT, seed=3)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, 16, 64, 64), generator=gen)
    t = torch.tensor([0.7])
    cond = {"context": torch.randn((1, 16, 64), generator=gen),
            "vec": torch.randn((1, 32), generator=gen), "guidance": torch.tensor([3.5])}
    ok, ran = _small_reference(
        "phase 5 small DiT reference", models,
        lambda mod, dev: mod(x.to(dev), t.to(dev), cond["context"].to(dev),
                             cond["vec"].to(dev), cond["guidance"].to(dev)),
        dict(cfg=1.0), (1, 16, 64, 64), (cond, None),
        calculate_sigmas(models[0][0].sigma_table, "simple", 4))
    if not (ok and ran["attention"] and ran["layernorm"] and ran["rmsnorm_rope"]):
        raise AssertionError("the small DiT on the card is less accurate than the plain path "
                             "or did not go through the kernels")


SMALL_ZIMAGE = dataclasses.replace(zimage.Z_IMAGE_S3_CONFIG, hidden=256, num_heads=2,
                                   num_kv_heads=1, depth=2, refiner_depth=1,
                                   context_refiner_depth=1, ffn_dim=512, cap_dim=64)


def phase_small_zimage() -> None:
    """A small Z-Image at head dim 128 (hidden 256, 2 query heads over one
    k/v head, 1 + 1 refiner blocks, 2 main layers) on a 64x64 latent: its
    noise refiner (1,024 image tokens) and main layers (1,040 tokens) take
    the kernel, the context refiner's 16 text tokens stay plain; cfg 1 as
    the Z-Image path."""
    models = _three_ways(zoo.build_zimage, SMALL_ZIMAGE, seed=3)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((1, 16, 64, 64), generator=gen)
    t = torch.tensor([0.7])
    cond = {"context": torch.randn((1, 16, 64), generator=gen)}
    ok, ran = _small_reference(
        "phase 5b small Z-Image reference", models,
        lambda mod, dev: mod(x.to(dev), t.to(dev), cond["context"].to(dev)),
        dict(cfg=1.0), (1, 16, 64, 64), (cond, None),
        calculate_sigmas(models[0][0].sigma_table, "simple", 4))
    if not (ok and ran["attention"] and ran["rmsnorm"]):
        raise AssertionError("the small Z-Image on the card is less accurate than the plain "
                             "path or did not go through the kernels")


COUNTERS = {"flash_attention": attention.flash_attention,
            "wide_attention": attention.wide_attention, "layernorm": norms.layernorm,
            "rmsnorm": norms.rmsnorm, "rmsnorm_rope": norms.rmsnorm_rope,
            "fused_half_step": fused.fused_half_step, "fused_finish": fused.fused_finish}


def _zero_counters() -> None:
    for f in COUNTERS.values():
        f.launches = 0
    attention.flash_attention.cross_launches = 0


def _cross_ok(path: str) -> tuple:
    """(the cross-attention launches since `_zero_counters` as
    `telemetry.summary()` reports them, the path's want, equal)."""
    got = telemetry.summary()["cross_launches"]
    want = CROSS_PER_FORWARD.get(path, 0) * FORWARDS[path]
    return got, want, got == want


def _want(path: str) -> dict:
    """Every counter's expected launches in one timed run of `path`."""
    want = {k: n * FORWARDS[path] for k, n in PER_FORWARD[path].items()}
    for k, n in PER_RUN[path].items():
        want[k] = want.get(k, 0) + n
    return want


def _graph_replays() -> int:
    return telemetry.summary()["graphs"]["replays"]


@contextlib.contextmanager
def _timed_and_counted():
    """Time a block and count its kernels: yields a dict that holds, when
    the block ends, `wall` (seconds to a synchronize), `card` (the port's
    kernels the card ran, by family, from its trace, started before and
    read after the timed span), `host` (the wrappers' launches, what the
    host issued: a replayed graph's kernels pass no wrapper) and
    `replays` (the graphs replayed)."""
    result = {}
    _zero_counters()
    replays = _graph_replays()
    with telemetry.card_kernels() as card:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield result
        torch.cuda.synchronize()
        result["wall"] = time.perf_counter() - t0
    result.update(card=card, host={k: f.launches for k, f in COUNTERS.items()},
                  replays=_graph_replays() - replays)


def _launches_ok(counted: dict, want: dict) -> bool:
    """The card ran every kernel `want` times, and where no graph was
    replayed the host issued each wrapper's `want` (the row norm's two
    modes are one kernel on the card)."""
    return (counted["card"] == telemetry.families(want)
            and (counted["replays"] > 0 or counted["host"] == {k: want.get(k, 0)
                                                               for k in COUNTERS}))


def _main_path(label, path, smi, den, module, t_init, run, warmup, latent) -> dict:
    n_params = sum(p.numel() for p in module.parameters())
    t0 = time.perf_counter()
    warmup()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _timed_and_counted() as counted:
        out = run()
    wall, launches = counted["wall"], counted["card"]
    samples, den_hist = out if isinstance(out, tuple) else (out, out)  # ksampler: samples
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hh, ww = latent.shape[-2:]
    known = torch.ones((hh, ww), dtype=torch.bool, device="cuda")
    known[hh // 4:3 * hh // 4, ww // 4:3 * ww // 4] = False
    finite = bool(torch.isfinite(samples).all()) and bool(torch.isfinite(den_hist).all())
    known_err = float((samples - latent)[..., known].abs().max())
    moved = float((samples - latent)[..., ~known].abs().mean())
    fwd = FORWARDS[path]
    want = _want(path)
    ok = (finite and samples.shape == latent.shape and known_err <= 1e-3 and moved > 1e-2
          and _launches_ok(counted, want))
    say(f"{label}: {n_params / 1e9:.3f} B params bf16 (init {t_init:.1f} s), {fwd} forwards | "
        f"first run {t_first:.2f} s, timed run {wall:.3f} s = {1e3 * wall / fwd:.2f} ms per "
        f"forward, peak {peak_gb:.1f} GB on {smi} | finite {finite} known-region max err "
        f"{known_err:.3g} repainted mean change {moved:.3g} | card's kernels {launches} "
        f"(want {telemetry.families(want)}), graphs replayed {counted['replays']}, host "
        f"issued {counted['host']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} check failed")
    return launches


def _centre_mask(hh, ww):
    """1 over the centre half of each side, 0 elsewhere."""
    mask = torch.zeros((hh, ww), device="cuda")
    mask[hh // 4:3 * hh // 4, ww // 4:3 * ww // 4] = 1.0
    return mask


def _build_sdxl():
    t0 = time.perf_counter()
    den, module = zoo.build_sdxl(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    return den, module, time.perf_counter() - t0


def _sdxl_conds(gen):
    return tuple({"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
                  "y": torch.randn((1, 2816), device="cuda", generator=gen)} for _ in range(2))


def phase_sdxl(smi: str) -> tuple:
    """Returns (launches, the SDXL Denoiser) so the pixel phase reuses it."""
    den, module, t_init = _build_sdxl()
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    cond, uncond = _sdxl_conds(gen)
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP),
                          sampler_name="euler", cfg=5.0, sequential_cfg=True)

    def run(steps=STEPS):
        return sam(latent=latent, sigmas=calculate_sigmas(den.sigma_table, "karras", steps),
                   cond=cond, uncond=uncond, mask=_centre_mask(1024, 1024), seed=0)

    return _main_path(f"phase 6 SDXL main path: euler karras {STEPS} x think {THINK}, cfg 5 "
                      "sequential (warm-up: 2 steps)", "sdxl", smi, den, module, t_init, run,
                      lambda: run(2), latent), den


def _vae_times(model, image) -> tuple:
    """(encode ms, decode ms, the latent): median of 3 calls after one warm-up."""
    with torch.no_grad():
        latent = model.encode(image)
        enc = median_ms(lambda: model.encode(image), n=3, warmup=1)
        dec = median_ms(lambda: model.decode(latent), n=3, warmup=1)
    return enc, dec, latent


def _pixel_workflow(entry, den, model, source, path, **kw) -> tuple:
    """One timed and counted call of a pixel workflow (`inpaint_image`, a
    pipeline's call wrapped to its signature, or `inpaint_video`, which
    takes `source` as its video) with a 2D centre mask and MaskBlend
    overlap BLEND.  Checks that the output is finite and of the source's
    shape, that every pixel (of every frame) farther than the blend from the
    mask equals the source bit for bit, that the repainted region moved, and
    that every kernel ran exactly as `path` expects (`_launches_ok`).
    Returns (ok, the card's kernels by family, the result's text, the
    output)."""
    hh, ww = source.shape[-2:]
    mask = _centre_mask(hh, ww)
    source_kw = {"video" if entry is inpaint_video else "image": source}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _timed_and_counted() as counted:
        out = entry(den, model, mask=mask, blend_overlap=BLEND, **source_kw, **kw)
    wall, launches = counted["wall"], counted["card"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    far = torch.ones((hh, ww), dtype=torch.bool, device="cuda")
    far[hh // 4 - BLEND:3 * hh // 4 + BLEND, ww // 4 - BLEND:3 * ww // 4 + BLEND] = False
    finite = bool(torch.isfinite(out).all())
    kept = torch.equal(out[..., far], source[..., far])
    moved = float((out - source)[..., mask > 0].abs().mean())
    want = _want(path)
    cross, cross_want, cross_ok = _cross_ok(path)
    ok = (finite and out.shape == source.shape and kept and moved > 1e-2
          and _launches_ok(counted, want) and cross_ok)
    fwd = FORWARDS[path]
    text = (f"{fwd} forwards, timed run {wall:.3f} s = {1e3 * wall / fwd:.2f} ms per forward, "
            f"peak {peak_gb:.1f} GB | finite {finite} shape {tuple(out.shape)} beyond-blend "
            f"pixels bit-equal {kept} repainted mean change {moved:.3g} | card's kernels "
            f"{launches} (want {telemetry.families(want)}), graphs replayed "
            f"{counted['replays']}, host issued {counted['host']}, cross-attention launches "
            f"{cross} (want {cross_want}) {'ok' if ok else 'FAIL'}")
    return ok, launches, text, out


def _build_sdxl_vae():
    t0 = time.perf_counter()
    model = zoo.build_vae(vae.SDXL_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


# the pixel workflows' sampler settings: euler karras, CFG 5 as two passes
PIXEL_KW = dict(seed=0, steps=STEPS, cfg=5.0, scheduler="karras", num_steps=THINK,
                sequential_cfg=True)


def _pixel_image(side: int):
    gen = torch.Generator(device="cuda").manual_seed(2)
    return torch.rand((1, 3, side, side), device="cuda", generator=gen) * 2.0 - 1.0, gen


def phase_pixel(smi: str, den=None, model=None, conds=None) -> tuple:
    """Pixel-space inpainting at 1024^2: `api.inpaint_image` with the SDXL
    UNet (phase 6's, or a new one) and the SDXL VAE (phase 12's, or a new
    one), random bf16 weights, and `conds` (phase 12's prompt encodings, or
    random ones).  Returns (launches, the output)."""
    if den is None:
        den, _, _ = _build_sdxl()
    t_init = 0.0
    if model is None:
        model, t_init = _build_sdxl_vae()
    n_params = sum(p.numel() for p in model.parameters())
    image, gen = _pixel_image(1024)
    cond, uncond = _sdxl_conds(gen) if conds is None else conds
    enc_ms, dec_ms, latent = _vae_times(model, image)
    if latent.shape != (1, 4, 128, 128) or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"SDXL VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    ok, launches, text, out = _pixel_workflow(
        inpaint_image, den, model, image, "pixel", positive=cond, negative=uncond, **PIXEL_KW)
    say(f"phase 7 pixel path: inpaint_image, SDXL VAE ({n_params / 1e6:.1f} M params bf16, "
        f"init {t_init:.1f} s) + SDXL euler karras {STEPS} x think {THINK}, cfg 5 sequential, "
        f"blend {BLEND}, {'random' if conds is None else 'the pipeline prompt encodings as'} "
        f"conds | VAE encode {enc_ms:.2f} ms decode {dec_ms:.2f} ms (1024^2, median of 3) | "
        f"{text} on {smi}")
    if not ok:
        raise AssertionError("phase 7 pixel path check failed")
    return launches, out


def _vae_round_trip(label, model, shape, latent_shape, seed, smi, extra_ok=True) -> None:
    """One encode-decode round trip of `model` on a random `shape` input in
    [-1, 1], each half timed alone: the latent of `latent_shape`, the output
    of `shape`, both finite, and the wide-head attention launched twice
    (the mid attention of the encoder and of the decoder)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, device="cuda", generator=gen) * 2.0 - 1.0
    enc_ms, dec_ms, _ = _vae_times(model, x)
    _zero_counters()
    with torch.no_grad():
        latent = model.encode(x)
        out = model.decode(latent)
    torch.cuda.synchronize()
    wide = attention.wide_attention.launches
    ok = (tuple(latent.shape) == latent_shape and tuple(out.shape) == shape
          and bool(torch.isfinite(latent).all()) and bool(torch.isfinite(out).all())
          and wide == 2 and extra_ok)
    say(f"{label}: encode {enc_ms:.2f} ms -> {tuple(latent.shape)}, decode {dec_ms:.2f} ms -> "
        f"{tuple(out.shape)} (median of 3) on {smi} | finite | wide-head attention launches "
        f"{wide} (want 2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} round trip failed")


def phase_flux_vae(smi: str) -> None:
    """One encode-decode round trip of the Flux VAE (no quant convs) at 1024^2."""
    model = zoo.build_vae(vae.FLUX_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=4)
    _vae_round_trip("phase 9 Flux VAE", model, (1, 3, 1024, 1024), (1, 16, 128, 128), 3, smi,
                    extra_ok=model.encoder.quant_conv is None)


def phase_flux(smi: str) -> dict:
    t0 = time.perf_counter()
    den, module = zoo.build_flux_dev(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 16, 128, 128), device="cuda", generator=gen)
    cond = {"context": torch.randn((1, 512, 4096), device="cuda", generator=gen),
            "vec": torch.randn((1, 768), device="cuda", generator=gen),
            "guidance": torch.tensor([3.5], device="cuda")}
    sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP,
                                                     use_fused_kernels=True),
                          sampler_name="euler", cfg=1.0)
    if sam.cfg_big != 1.0:
        raise AssertionError("Flux must force cfg_big to 1")

    def run(steps=STEPS):
        return sam(latent=latent, sigmas=calculate_sigmas(den.sigma_table, "simple", steps),
                   cond=cond, mask=_centre_mask(1024, 1024), seed=0)

    launches = _main_path(f"phase 8 Flux main path: euler simple {STEPS} x think {THINK}, "
                          "cfg 1, fused think step (warm-up: 2 steps)", "flux", smi, den, module,
                          t_init, run, lambda: run(2), latent)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: den.apply(latent, t_mid, cond))
    say(f"phase 8 Flux forward at t = 0.7 under torch.profiler: {_profile_text(prof)}")
    _tp_check("phase 24a Flux-dev", "flux", smi,
              lambda st, **kw: zoo.build_flux_dev(st, tp_axis="tensor", layer_axis="data", **kw),
              module.state_dict(), den, latent, t_mid, cond,
              after=_dp_fused_check(smi, sam, latent,
                                    calculate_sigmas(den.sigma_table, "simple", 2), cond,
                                    _centre_mask(1024, 1024)))
    return launches


def phase_flux2(smi: str) -> dict:
    """FLUX.2 [dev] at its published widths (64.4 GB of bf16 weights drawn
    on the card) at the benchmark cell's 1248x832 with its reference
    latent: one forward under torch.profiler, then `_main_path` through
    `api.ksampler` (euler "simple", cfg 1, guidance 4, 4 steps x 2 think),
    its shared modulations (3 a forward) and SwiGLU calls (64) counted."""
    t0 = time.perf_counter()
    den, module = zoo.build_flux2_dev(device="cuda", param_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(7)
    latent = torch.randn(FLUX2_LATENT, device="cuda", generator=gen)
    cond = {"context": torch.randn((1, FLUX2_TXT, 15360), device="cuda", generator=gen),
            "guidance": torch.tensor([4.0], device="cuda"),
            "ref_tokens": torch.randn((1, FLUX2_REF, 128), device="cuda", generator=gen)}
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: den.apply(latent, t_mid, cond))
    say(f"phase 8b FLUX.2 forward at t = 0.7 under torch.profiler: {_profile_text(prof)}")
    hh, ww = (8 * n for n in FLUX2_LATENT[-2:])
    counted = {}

    def run(steps=FLUX2_STEPS):
        before = flux2.SharedModulation.calls, flux2.swiglu.calls
        out = api.ksampler(den, positive=cond, latent=latent, mask=_centre_mask(hh, ww),
                           steps=steps, **dict(FLOW_KW, num_steps=VIDEO_THINK))
        counted.update(modulation=flux2.SharedModulation.calls - before[0],
                       swiglu=flux2.swiglu.calls - before[1])
        return out

    launches = _main_path(f"phase 8b FLUX.2 main path: ksampler, euler simple {FLUX2_STEPS} x "
                          f"think {VIDEO_THINK}, cfg 1, {ww}x{hh} with the reference latent "
                          "(warm-up: 2 steps)", "flux2", smi, den, module, t_init, run,
                          lambda: run(2), latent)
    want = {"modulation": 3 * FORWARDS["flux2"], "swiglu": 64 * FORWARDS["flux2"]}
    ok = counted == want
    say(f"phase 8b FLUX.2 shared modulations and SwiGLU calls in the timed run: {counted} "
        f"(want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 8b FLUX.2 counters")
    del den, module
    return launches


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_forward(fn) -> dict:
    """One call of `fn` (after one unprofiled call) under torch.profiler:
    its wall clock to a synchronize, the CUDA kernels' summed self time in
    the same window, the card's idle share between them, the kernel count,
    and the largest kernels by device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernels only: a span's annotation on the kernels' clock (FLUX.2's
    # `dit.double` / `dit.single` inside the forward) is no kernel
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_self_device_us(e) for e in cuda) / 1e3
    top = sorted(cuda, key=_self_device_us, reverse=True)[:8]
    classes = {}
    for e in cuda:
        name = _kernel_class(e.key)
        classes[name] = classes.get(name, 0.0) + _self_device_us(e) / 1e3
    return dict(wall_ms=wall_ms, device_ms=device_ms, idle=1.0 - device_ms / wall_ms,
                kernels=sum(e.count for e in cuda),
                top=[(e.key[:48], round(_self_device_us(e) / 1e3, 3), e.count) for e in top],
                classes={k: round(v, 3) for k, v in sorted(classes.items())})


# kernel classes by name, first match: this package's kernels, then the libraries'
KERNEL_CLASSES = (("attention", ("flash_fwd", "wide_fwd")), ("row norm", ("row_norm",)),
                  ("conv", ("conv", "fprop", "implicit", "nhwc", "nchw", "cudnn")),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma")))


def _kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")


def _profile_text(prof) -> str:
    return (f"wall {prof['wall_ms']:.2f} ms, kernels {prof['device_ms']:.2f} ms in "
            f"{prof['kernels']}, idle {100 * prof['idle']:.1f}%, top {prof['top']}")


def phase_video(smi: str) -> dict:
    """Wan2.2 TI2V-5B video inpainting at 704x1280 x 33 frames:
    `api.inpaint_video` with its defaults (euler "simple", 20 steps x 2
    think, CFG 5, here as two sequential passes, blend 9) on the TI2V-5B
    DiT and the Wan2.2 VAE, random bf16 weights, a random video and a 2D
    centre mask; a 2-step warm-up call, then one timed and counted call."""
    t0 = time.perf_counter()
    den, module = zoo.build_wan(wan.WAN22_TI2V_5B_CONFIG, device="cuda",
                                param_dtype=torch.bfloat16, seed=0, name="wan22-ti2v-5b")
    model = zoo.build_wan_vae(video_vae.WAN22_VAE_CONFIG, device="cuda",
                              param_dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_dit = sum(p.numel() for p in module.parameters())
    n_vae = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(5)
    video = torch.rand(VIDEO_SHAPE, device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = ({"context": torch.randn((1, 512, 4096), device="cuda", generator=gen)}
                    for _ in range(2))
    enc_ms, dec_ms, latent = _vae_times(model, video)
    if tuple(latent.shape) != (1, 48, 9, 44, 80) or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"Wan2.2 VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    pre = den.precompute(cond)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: den.apply(latent, t_mid, pre))
    del pre

    kw = dict(positive=cond, negative=uncond, seed=0, sequential_cfg=True)
    t0 = time.perf_counter()
    inpaint_video(den, model, video=video, mask=_centre_mask(*VIDEO_SHAPE[-2:]), steps=2,
                  blend_overlap=BLEND, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    ok, launches, text, _ = _pixel_workflow(inpaint_video, den, model, video, "video", **kw)
    say(f"phase 10 video path: inpaint_video, Wan2.2 TI2V-5B ({n_dit / 1e9:.3f} B params bf16) + "
        f"Wan2.2 VAE ({n_vae / 1e6:.1f} M), init {t_init:.1f} s | {VIDEO_SHAPE} -> latent "
        f"{tuple(latent.shape)}, S = 7920 | VAE encode {enc_ms:.2f} ms decode {dec_ms:.2f} ms "
        f"(median of 3) | one forward at t = 0.7 under torch.profiler: {_profile_text(prof)} "
        f"| euler simple {STEPS} x think "
        f"{VIDEO_THINK}, cfg 5 sequential, blend {BLEND}, first run (2 steps) {t_first:.2f} s, "
        f"{text} on {smi}")
    if not ok:
        raise AssertionError("phase 10 video path check failed")
    return launches


def phase_pair(smi: str) -> dict:
    """Wan2.2 T2V-A14B video inpainting at 480x832 x 33 frames:
    `api.inpaint_video` with its defaults (euler "simple", 20 steps x 2
    think, CFG 5, here as two sequential passes, blend 9) on
    `zoo.switching_denoiser` over two WAN22_T2V_14B_CONFIG experts (random
    bf16 weights, seeds 0 and 1) and the Wan2.1 VAE, a random video and a 2D
    centre mask; a 2-step warm-up call, then one timed and counted call with
    each expert's forwards counted."""
    t0 = time.perf_counter()
    experts, n_params, counts = {}, {}, {"high": 0, "low": 0}
    for key, seed in (("high", 0), ("low", 1)):
        den, module = zoo.build_wan(wan.WAN22_T2V_14B_CONFIG, device="cuda",
                                    param_dtype=torch.bfloat16, seed=seed,
                                    name=f"wan22-t2v-a14b-{key}")
        _count_calls(den, counts, key)
        experts[key], n_params[key] = den, sum(p.numel() for p in module.parameters())
    pair = zoo.switching_denoiser(experts["high"], experts["low"], boundary=BOUNDARY)
    model = zoo.build_wan_vae(video_vae.WAN21_VAE_CONFIG, device="cuda",
                              param_dtype=torch.bfloat16, seed=2)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_vae = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(5)
    video = torch.rand(WAN21_SHAPE, device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = ({"context": torch.randn((1, 512, 4096), device="cuda", generator=gen)}
                    for _ in range(2))
    enc_ms, dec_ms, latent = _vae_times(model, video)
    b, _, frames, hh, ww = WAN21_SHAPE  # (1, 16, 9, 60, 104): stride 4 in time, 8 in space
    want = (b, 16, 1 + (frames - 1) // 4, hh // 8, ww // 8)
    if tuple(latent.shape) != want or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"Wan2.1 VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    pre = pair.precompute(cond)
    profiles = {}
    for key, t in (("high", 0.9), ("low", 0.7)):
        before = dict(counts)
        t_dev = torch.tensor([t], device="cuda")
        profiles[key] = profile_forward(lambda: pair.route(t)(latent, t_dev, pre))
        if counts[key] - before[key] != 2 or sum(counts.values()) - sum(before.values()) != 2:
            raise AssertionError(f"the pair did not route t = {t} to the {key}-noise expert")
    del pre

    kw = dict(positive=cond, negative=uncond, seed=0, sequential_cfg=True)
    t0 = time.perf_counter()
    inpaint_video(pair, model, video=video, mask=_centre_mask(*WAN21_SHAPE[-2:]), steps=2,
                  blend_overlap=BLEND, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    if min(counts.values()) < 4:  # the warm-up's ladder 1.0, 0.833, 0 runs both experts
        raise AssertionError(f"the warm-up left an expert cold: {counts}")
    counts.update(high=0, low=0)
    ok, launches, text, _ = _pixel_workflow(inpaint_video, pair, model, video, "pair", **kw)
    ok = ok and counts == EXPERT_FORWARDS
    say(f"phase 11 pair path: inpaint_video, Wan2.2 T2V-A14B pair (high "
        f"{n_params['high'] / 1e9:.3f} B + low {n_params['low'] / 1e9:.3f} B params bf16, "
        f"boundary {BOUNDARY}) + Wan2.1 VAE ({n_vae / 1e6:.1f} M), init {t_init:.1f} s | "
        f"{WAN21_SHAPE} -> latent {tuple(latent.shape)}, S = {latent[0, 0].numel() // 4} | VAE "
        f"encode {enc_ms:.2f} ms decode {dec_ms:.2f} ms (median of 3; mid attention at D = 384) "
        f"| one forward under "
        f"torch.profiler: high expert at t = 0.9: {_profile_text(profiles['high'])}; low expert "
        f"at t = 0.7: {_profile_text(profiles['low'])} | euler simple {STEPS} x think "
        f"{VIDEO_THINK}, cfg 5 sequential, blend {BLEND}, first run (2 steps) {t_first:.2f} s, "
        f"expert forwards {counts} (want {EXPERT_FORWARDS}), {text} on {smi}")
    if not ok:
        raise AssertionError("phase 11 pair path check failed")
    return launches


# --------------------------------------------------------------------------
# phases 12-14: checkpoint loading, the text stack and LanPaintPipeline

PROMPT = "a photo of a corgi sitting on a wooden bench, best quality"
LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _synthetic_clip_files(directory: str) -> tuple:
    """vocab.json / merges.txt of CLIP's full size, 49,408 entries: the 256
    byte symbols and their 256 end-of-word forms, 48,894 merges (two-,
    three- and four-letter pieces over a-z, in rank order), and
    <|startoftext|> = 49406, <|endoftext|> = 49407.  Returns their paths."""
    vocab = {}
    for ch in sorted(tokenizers.bytes_to_unicode().values()):
        vocab[ch] = len(vocab)
    for ch in sorted(tokenizers.bytes_to_unicode().values()):
        vocab[ch + "</w>"] = len(vocab)
    merges = []
    pairs = itertools.chain(
        ((a, b + end) for a, b in itertools.product(LETTERS, LETTERS) for end in ("", "</w>")),
        ((a + b, c + end) for a, b, c in itertools.product(LETTERS, LETTERS, LETTERS)
         for end in ("", "</w>")),
        ((a + b + c, d + "</w>") for a, b, c, d in itertools.product(*[LETTERS] * 4)))
    for a, b in pairs:
        if len(vocab) == 49406:
            break
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    vocab_path, merges_path = (os.path.join(directory, n) for n in ("vocab.json", "merges.txt"))
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return vocab_path, merges_path


def _synthetic_unigram(vocab_size: int) -> tokenizers.UnigramTokenizer:
    """A SentencePiece unigram vocabulary of `vocab_size` pieces with T5's
    special ids (<pad> 0, </s> 1, <unk> 2): "▁", the prompt's words, a-z,
    and filler pieces up to the size."""
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -3.0)]
    pieces += [("▁" + w, -1.0) for w in sorted(set(PROMPT.replace(",", "").split()))]
    pieces += [(c, -4.0) for c in LETTERS + ","]
    pieces += [(f"<filler_{i}>", -30.0) for i in range(vocab_size - len(pieces))]
    return tokenizers.UnigramTokenizer(pieces, unk_id=2, eos_token_id=1)


def write_safetensors(path: str, tensors: dict) -> int:
    """Write `tensors` (torch, on any device) as a BF16 safetensors file:
    the header's byte length (u64, little-endian), the JSON header padded
    with spaces to 8 bytes, then each tensor's bytes in the header's order,
    one tensor on the host at a time.  Returns the file's size in bytes."""
    header, offset = {}, 0
    for key, t in tensors.items():
        header[key] = {"dtype": "BF16", "shape": list(t.shape),
                       "data_offsets": [offset, offset + 2 * t.numel()]}
        offset += 2 * t.numel()
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().to(torch.bfloat16).contiguous().cpu().view(torch.int16).numpy().data)
    return 8 + len(blob) + offset


def _hf_to_openclip(sd: dict, layers: int) -> dict:
    """An HF-layout CLIP state (`load.export_clip`'s keys) in the OpenCLIP
    text-tower layout of single-file SDXL checkpoints (fused in_proj, the
    projection stored as (width, proj) and used as x @ proj)."""
    out = {
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T,
    }
    for i in range(layers):
        hf, oc = f"text_model.encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for part in ("weight", "bias"):
            out[oc + "attn.in_proj_" + part] = torch.cat(
                [sd[hf + f"self_attn.{n}_proj.{part}"] for n in "qkv"], dim=0)
            for src, dst in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"),
                             ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj")):
                out[f"{oc}{dst}.{part}"] = sd[f"{hf}{src}.{part}"]
    return out


# the loading steps timed inside from_single_file: (module, function, span)
LOAD_SPANS = [(load, "load_safetensors", "read"), (load, "split_checkpoint", "split and import")]
LOAD_SPANS += [(load, n, "split and import")
               for n in ("import_unet", "import_vae", "import_clip", "import_clip_openclip")]
LOAD_SPANS += [(zoo, "build_unet", "to the card"), (zoo, "build_vae", "to the card"),
               (zoo, "build_clip", "to the card")]


@contextlib.contextmanager
def _timed_calls(targets):
    """Inside the block, every call of each (module, function, span) of
    `targets` adds its seconds (to a synchronize) to the yielded dict's
    `span` (the functions are looked up on their modules at call time)."""
    spans, saved = {}, []
    for mod, name, span in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*args, _fn=fn, _span=span, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spans[_span] = spans.get(_span, 0.0) + time.perf_counter() - t0

        setattr(mod, name, timed)
    try:
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _same_weights(a, b) -> bool:
    """Whether two modules hold the same parameters, bit for bit."""
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def _single_file(label, parts, directory, **pipe_kw) -> tuple:
    """Write `parts` [(prefix, checkpoint dict)] as one BF16 safetensors
    file in `directory`, then `LanPaintPipeline.from_single_file` it in bf16
    with the synthetic CLIP vocabulary.  Returns (pipe, the text of the
    sizes and times)."""
    tensors = {prefix + k: v for prefix, part in parts for k, v in part.items()}
    n_params = sum(t.numel() for t in tensors.values())
    path = os.path.join(directory, "model.safetensors")
    t0 = time.perf_counter()
    size = write_safetensors(path, tensors)
    t_write = time.perf_counter() - t0
    del tensors
    vocab_path, merges_path = _synthetic_clip_files(directory)
    native_loader.CONVERSIONS.update(native=0, torch=0)
    t0 = time.perf_counter()
    with _timed_calls(LOAD_SPANS) as spans:
        pipe = LanPaintPipeline.from_single_file(path, vocab=vocab_path, merges=merges_path,
                                                 param_dtype=torch.bfloat16, **pipe_kw)
    t_load = time.perf_counter() - t0
    gc.collect()  # the host's read buffer and fp32 arrays
    conv = dict(native_loader.CONVERSIONS)
    if not conv["native"] or conv["torch"]:
        raise AssertionError(f"{label}: the reader did not widen natively: {conv}")
    text_ = (f"{n_params / 1e9:.3f} B params, {size / 1e9:.3f} GB BF16 file: write "
             f"{t_write:.2f} s, from_single_file {t_load:.2f} s = read (native reader) "
             f"{spans['read']:.2f} s + split and import {spans['split and import']:.2f} s + to "
             f"the card {spans['to the card']:.2f} s; tensors widened {conv}")
    return pipe, text_


def phase_single_file(smi: str, den, directory: str) -> tuple:
    """Single-file SDXL at full width: phase 6's UNet, a new SDXL VAE (seed
    1, phase 7's), a seeded CLIP-L in the HF layout and a CLIP-G in the
    OpenCLIP layout, exported into one BF16 safetensors file in `directory`
    (the caller's, which it removes), read back with `from_single_file`: the family and
    the encoders, every tensor of the UNet, the VAE and both towers bit-equal
    to its source, and `pipe.encode` timed and checked.  The VAE config is
    passed: the JAX package's pipeline defaults to SD_VAE_CONFIG's scale for
    both families.  The file (and the vocabulary) stay there for phase 21.
    Returns (pipe, the VAE, the prompt's and the empty prompt's conds)."""
    model, _ = _build_sdxl_vae()
    towers = {name: zoo.build_clip(cfg, device="cuda", param_dtype=torch.bfloat16, seed=seed)
              for name, cfg, seed in (("clip_l", textenc.CLIP_L_CONFIG, 2),
                                      ("clip_g", textenc.CLIP_G_CONFIG, 3))}
    parts = [
        ("model.diffusion_model.",
         load.export_unet(den.module.state_dict(), unet.SDXL_CONFIG, prefix="")),
        ("first_stage_model.", load.export_vae(model.state_dict(), vae.SDXL_VAE_CONFIG)),
        ("conditioner.embedders.0.transformer.",
         load.export_clip(towers["clip_l"].state_dict(), textenc.CLIP_L_CONFIG)),
        ("conditioner.embedders.1.model.", _hf_to_openclip(
            load.export_clip(towers["clip_g"].state_dict(), textenc.CLIP_G_CONFIG),
            textenc.CLIP_G_CONFIG.layers)),
    ]
    pipe, loaded = _single_file("phase 12", parts, directory, vae_config=vae.SDXL_VAE_CONFIG)
    del parts
    same = {"unet": _same_weights(pipe.model.module, den.module),
            "vae": _same_weights(pipe.vae, model)}
    same.update({n: _same_weights(pipe.encoders[n].module, t) for n, t in towers.items()})
    conds = (pipe.encode(PROMPT), pipe.encode(""))
    enc_ms = median_ms(lambda: pipe.encode(PROMPT), n=3, warmup=1)
    ctx, y = conds[0]["context"], conds[0]["y"]
    ok = (pipe.family == "sdxl" and sorted(pipe.encoders) == ["clip_g", "clip_l"]
          and all(same.values()) and tuple(ctx.shape) == (1, 77, 2048)
          and tuple(y.shape) == (1, 2816)
          and all(bool(torch.isfinite(c[k]).all()) for c in conds for k in c))
    say(f"phase 12 single-file SDXL: {loaded} | family {pipe.family}, encoders "
        f"{sorted(pipe.encoders)}, bit-equal to the sources {same} | encode: context "
        f"{tuple(ctx.shape)} y {tuple(y.shape)} finite, {enc_ms:.2f} ms (median of 3) on {smi} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 12 single-file load failed its checks")
    return pipe, model, conds


def _pipe_entry(pipe):
    """`pipe`'s call in `_pixel_workflow`'s entry signature."""
    return lambda _den, _model, **kw: pipe(PROMPT, **kw)


def phase_pipeline_run(smi: str, pipe, reference) -> dict:
    """The single-file SDXL pipeline's call, `pipe(PROMPT, image=...,
    mask=..., steps=20, num_steps=5, cfg=5.0, sequential_cfg=True, seed=0)`
    on phase 7's image and mask: phase 7's checks, and the output bit-equal
    to phase 7's `inpaint_image` on the source UNet and VAE with the same
    prompt encodings."""
    image, _ = _pixel_image(1024)
    ok, launches, text_, out = _pixel_workflow(_pipe_entry(pipe), None, None, image, "pipeline",
                                               **PIXEL_KW)
    same = torch.equal(out, reference)
    say(f"phase 12 pipeline call: LanPaintPipeline(prompt, image, mask), SDXL euler karras "
        f"{STEPS} x think {THINK}, cfg 5 sequential, blend {BLEND} | {text_} | output bit-equal "
        f"to phase 7's inpaint_image {same} on {smi} {'ok' if ok and same else 'FAIL'}")
    if not (ok and same):
        raise AssertionError("phase 12 pipeline call failed its checks")
    return launches


# --------------------------------------------------------------------------
# phases 20-21: the ControlNet adapter, LoRA merging and the HTTP server


def _hinted_conds(gen, hint):
    """Phase 6's random SDXL conds with the control image in both (batched
    CFG needs the same keys in cond and uncond)."""
    return tuple(dict(c, hint=hint) for c in _sdxl_conds(gen))


def phase_controlnet(smi: str, den) -> dict:
    """SDXL-1024 with a ControlNet (`zoo.build_controlled_unet(SDXL_CONFIG,
    ...)`): phase 6's UNet state, a ControlNet of random bf16 weights (seed
    1) whose zero convs and middle_block_out are drawn too (they start at
    zero without a state, and the control would add nothing), a seeded
    (1, 3, 1024, 1024) hint in both conds.  Checks: the ControlNet's
    residuals (9 skips and the middle, finite); one forward of the same
    modules at strength 0 bit-equal to the forward without a hint; phase
    6's run at strength 1 after a 2-step warm-up (timed and counted, 104
    flash_attention and 312 layernorm launches a forward); one forward at
    strength 1 different from the forward without a hint.  One forward
    with the hint and one without are profiled (the card's idle share and
    device time by kernel class)."""
    t0 = time.perf_counter()
    cden, (c_unet, cn) = zoo.build_controlled_unet(unet.SDXL_CONFIG, den.module.state_dict(),
                                                   device="cuda", param_dtype=torch.bfloat16,
                                                   seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for conv in cn.zero_convs():
            conv.weight.normal_(0.0, 0.02, generator=gen)
    zden, _ = zoo.build_controlled_unet(unet.SDXL_CONFIG, c_unet.state_dict(), cn.state_dict(),
                                        strength=0.0, device="cuda", param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_cn = _params(cn)

    gen = torch.Generator(device="cuda").manual_seed(0)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    hint = torch.rand((1, 3, 1024, 1024), device="cuda", generator=gen) * 2.0 - 1.0
    cond, uncond = _hinted_conds(gen, hint)
    sigma = torch.tensor([3.0], device="cuda")
    with torch.no_grad():
        x_in = latent / math.sqrt(1.0 + 3.0**2)
        res = cn(x_in, hint, torch.tensor([500.0], device="cuda"), cond["context"], cond["y"])
        plain = zden.apply(latent, sigma, {k: v for k, v in cond.items() if k != "hint"})
        at_zero = zden.apply(latent, sigma, cond)
    torch.cuda.synchronize()
    n_res = len(res["output"])
    res_ok = (n_res == 9 and all(bool(torch.isfinite(r).all()) and float(r.abs().mean()) > 0
                                 for r in res["output"] + [res["middle"]]))
    zero_same = torch.equal(plain, at_zero)
    say(f"phase 20 ControlNet: {n_cn / 1e9:.3f} B params bf16 beside the UNet's "
        f"{_params(c_unet) / 1e9:.3f} B (init {t_init:.1f} s, both strengths) | residuals: "
        f"{n_res} skips {[tuple(r.shape[1:]) for r in res['output']]} + middle "
        f"{tuple(res['middle'].shape[1:])}, finite and non-zero {res_ok} | strength-0 forward "
        f"bit-equal to the forward without a hint {zero_same} on {smi} "
        f"{'ok' if res_ok and zero_same else 'FAIL'}")
    if not (res_ok and zero_same):
        raise AssertionError("phase 20 ControlNet residual checks failed")
    del res, plain, at_zero
    bare = {k: v for k, v in cond.items() if k != "hint"}
    profiles = {key: profile_forward(lambda c=c: cden.apply(latent, sigma, c))
                for key, c in (("controlled", cond), ("hint-less", bare))}
    say(f"phase 20 one forward at sigma 3 under torch.profiler, strength 1: "
        f"{_profile_text(profiles['controlled'])}, by class (ms) "
        f"{profiles['controlled']['classes']} | the same module without a hint: "
        f"{_profile_text(profiles['hint-less'])}, by class (ms) "
        f"{profiles['hint-less']['classes']} on {smi}")

    sigmas = calculate_sigmas(cden.sigma_table, "karras", STEPS)
    config = LanPaintConfig(n_steps=THINK, outer_early_stop=EARLY_STOP)
    outs = {}

    def sampled(model, key):
        sam = LanPaintSampler(model, config=config, sampler_name="euler", cfg=5.0,
                              sequential_cfg=True)
        return lambda: outs.setdefault(key, sam(latent=latent, sigmas=sigmas, cond=cond,
                                                uncond=uncond, mask=_centre_mask(1024, 1024),
                                                seed=0))

    warm_up = lambda: LanPaintSampler(  # noqa: E731
        cden, config=config, sampler_name="euler", cfg=5.0, sequential_cfg=True)(
        latent=latent, sigmas=calculate_sigmas(cden.sigma_table, "karras", 2), cond=cond,
        uncond=uncond, mask=_centre_mask(1024, 1024), seed=0)
    launches = _main_path(
        f"phase 20 SDXL + ControlNet main path: euler karras {STEPS} x think {THINK}, cfg 5 "
        f"sequential, strength 1 (warm-up: 2 steps)", "controlnet", smi, cden, cden.module,
        t_init, sampled(cden, "one"), warm_up, latent)
    with torch.no_grad():
        change = float((cden.apply(latent, sigma, cond) - cden.apply(latent, sigma, bare))
                       .abs().mean())
    say(f"phase 20 ControlNet: mean |strength 1 - no hint| of one forward at sigma 3 "
        f"{change:.4g} {'ok' if change > 1e-3 else 'FAIL'}")
    if not change > 1e-3:
        raise AssertionError("phase 20: the control did not move the output")
    return launches


# every attention projection of the UNet: the LoRA targets of phase 21
LORA_TARGETS = re.compile(r"^model\.diffusion_model\..*\.attn[12]\.to_(q|k|v|out\.0)\.weight$")
LORA_RANK, LORA_ALPHA, LORA_STRENGTH = 8, 4.0, 0.8


def _seeded_lora(state: dict, seed: int = 0) -> dict:
    """A kohya LoRA of rank LORA_RANK over every LORA_TARGETS weight of
    `state`: lora_down (r, in), lora_up (out, r), N(0, 0.05^2) from a numpy
    seed, and alpha."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(k for k in state if LORA_TARGETS.match(k)):
        o, i = state[key].shape
        base = lora._kohya_name(key)
        out[base + ".lora_down.weight"] = (0.05 * rng.standard_normal((LORA_RANK, i))).astype(
            np.float32)
        out[base + ".lora_up.weight"] = (0.05 * rng.standard_normal((o, LORA_RANK))).astype(
            np.float32)
        out[base + ".alpha"] = np.float32(LORA_ALPHA)
    return out


# the local server's client: no proxy, whatever the environment names
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(url: str, payload: dict, timeout: float = 600.0) -> tuple:
    """POST `payload` as JSON: (HTTP status, the decoded body, seconds)."""
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with _LOCAL.open(req, timeout=timeout) as resp:
            status, reply = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, reply = err.code, err.read()
    return status, json.loads(reply), time.perf_counter() - t0


def _get(url: str) -> tuple:
    try:
        with _LOCAL.open(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def phase_serve(smi: str, directory: str, ref_pipe) -> dict:
    """Serving a LoRA-merged single file over HTTP.  Phase 12's SDXL file
    read back (`load_safetensors`, numpy fp32), a seeded kohya LoRA of rank
    8 over every attn1 / attn2 to_q / to_k / to_v / to_out.0 weight merged
    at 0.8 (`models.lora.apply_lora`, timed on the host): a strength-0
    merge bit-equal to the source, one merged weight equal to w + 0.8 *
    (alpha / r) * up @ down in float64 within fp32 rounding, and the
    pipeline `from_single_file(state=merged)` gives a UNet forward that
    differs from phase 12's pipeline's.  Then `InpaintServer` with
    `pipeline_runner(batch_size=2)` and `pipeline_validator(2)` behind
    `make_http_server` on 127.0.0.1 (port 0), as `cmd_serve` stands them
    up; three 1024^2 requests POSTed with urllib at the default Variant
    (euler karras 20 x 5, cfg 5, batched CFG): two together (one batch,
    one with a request_id whose /progress is polled), then one alone (a
    padded batch) beside one of a wrong image shape (HTTP 500, alone).
    Checks: each answer (3, 1024, 1024), finite, every pixel beyond the
    blend bit-equal to its input, the repainted region moved, the two
    co-batched seeds' answers different; /stats 3 served in 2 batches, 1
    padded lane, 1 error; /progress done with think_steps_done; exact
    launches in each batch."""
    import numpy as np

    path = os.path.join(directory, "model.safetensors")
    vocab_path, merges_path = (os.path.join(directory, n) for n in ("vocab.json", "merges.txt"))
    t0 = time.perf_counter()
    state = load.load_safetensors(path)
    t_read = time.perf_counter() - t0
    lora_sd = _seeded_lora(state)
    n_pairs = sum(k.endswith(".lora_down.weight") for k in lora_sd)
    t0 = time.perf_counter()
    merged = lora.apply_lora(state, lora_sd, strength=LORA_STRENGTH)
    t_merge = time.perf_counter() - t0
    zero = lora.apply_lora(state, lora_sd, strength=0.0)
    targets = sorted(k for k in state if LORA_TARGETS.match(k))
    zero_same = all(zero[k].dtype == state[k].dtype
                    and np.array_equal(zero[k].view(np.uint32), state[k].view(np.uint32))
                    for k in targets)
    key = targets[0]
    base = lora._kohya_name(key)
    delta = lora_sd[base + ".lora_up.weight"].astype(np.float64) @ \
        lora_sd[base + ".lora_down.weight"].astype(np.float64)
    want = state[key].astype(np.float64) + LORA_STRENGTH * (LORA_ALPHA / LORA_RANK) * delta
    merge_err = float(np.abs(merged[key] - want).max())
    merge_ok = merged[key].dtype == np.float32 and np.allclose(merged[key], want, rtol=1e-6,
                                                                atol=1e-7)
    del zero, state
    t0 = time.perf_counter()
    pipe = LanPaintPipeline.from_single_file("<in-memory>", state=merged, vocab=vocab_path,
                                             merges=merges_path, param_dtype=torch.bfloat16,
                                             vae_config=vae.SDXL_VAE_CONFIG)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del merged
    gc.collect()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    sigma = torch.tensor([2.0], device="cuda")
    cond = ref_pipe.encode(PROMPT)
    with torch.no_grad():
        before = ref_pipe.model.apply(x, sigma, cond)
        after = pipe.model.apply(x, sigma, cond)
    fwd_change = float((after - before).abs().mean())
    load_ok = (zero_same and merge_ok and fwd_change > 1e-3
               and bool(torch.isfinite(after).all()))
    say(f"phase 21 LoRA: {n_pairs} kohya pairs of rank {LORA_RANK} (alpha {LORA_ALPHA}) over the "
        f"UNet's attention projections, the single file read {t_read:.2f} s (numpy fp32), merged "
        f"at {LORA_STRENGTH} in {t_merge:.3f} s on the host | strength-0 merge bit-equal "
        f"{zero_same}, {key} against float64 max err {merge_err:.3g} | from_single_file("
        f"state=merged) {t_load:.2f} s, a UNet forward's mean change from phase 12's pipeline "
        f"{fwd_change:.4g} on {smi} {'ok' if load_ok else 'FAIL'}")
    if not load_ok:
        raise AssertionError("phase 21 LoRA merge checks failed")
    del before, after, x

    board = serve.ProgressBoard()
    runner = serve.pipeline_runner(pipe, batch_size=2, progress=board)
    batches = []

    def counted(batch):  # each batch's seconds and the card's kernels
        with _timed_and_counted() as one:
            out = runner(batch)
        batches.append({"lanes": len(batch), "seconds": one["wall"], "counted": one})
        return out

    srv = serve.InpaintServer(counted, batch_size=2, max_delay_s=1.5,
                              validator=serve.pipeline_validator(2))
    httpd = serve.make_http_server(srv, host="127.0.0.1", port=0, progress=board)
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    rng = np.random.default_rng(7)
    side = 1024
    mask = np.zeros((side, side), np.float32)
    mask[side // 4:3 * side // 4, side // 4:3 * side // 4] = 1.0
    images = [rng.uniform(-1.0, 1.0, (3, side, side)).astype(np.float32) for _ in range(3)]
    t0 = time.perf_counter()
    payloads = [{"prompt": PROMPT, "image": serve._encode_array(img),
                 "mask": serve._encode_array(mask), "seed": 11 + i}
                for i, img in enumerate(images)]
    t_encode = (time.perf_counter() - t0) / 3
    payloads[0]["request_id"] = "a"
    bad = dict(payloads[2], image=serve._encode_array(images[2][:, :1000]))
    answers = {}

    def post(name, payload):
        answers[name] = _post(url + "/inpaint", payload)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    progress = []
    try:
        first = [threading.Thread(target=post, args=(n, p))
                 for n, p in (("a", payloads[0]), ("b", payloads[1]))]
        for t in first:
            t.start()
        while any(t.is_alive() for t in first):
            status, entry = _get(url + "/progress?id=a")
            if status == 200:
                progress.append((entry["step"], entry["total"], entry["done"]))
            time.sleep(0.25)
        for t in first:
            t.join()
        second = [threading.Thread(target=post, args=(n, p))
                  for n, p in (("c", payloads[2]), ("bad", bad))]
        for t in second:
            t.start()
        for t in second:
            t.join()
        wall = time.perf_counter() - t_all
        launches = telemetry.families({})
        for b in batches:
            for k, n in b["counted"]["card"].items():
                launches[k] += n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _, stats = _get(url + "/stats")
        _, done_entry = _get(url + "/progress?id=a")
        _, health = _get(url + "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    server_thread.join(timeout=60)

    t0 = time.perf_counter()
    outs = {n: serve._decode_array(answers[n][1]["image"]) for n in ("a", "b", "c")
            if answers[n][0] == 200}
    t_decode = (time.perf_counter() - t0) / max(1, len(outs))
    far = np.ones((side, side), bool)
    far[side // 4 - BLEND:3 * side // 4 + BLEND, side // 4 - BLEND:3 * side // 4 + BLEND] = False
    checks = {}
    for n, img in zip(("a", "b", "c"), images):
        out = outs.get(n)
        checks[n] = (out is not None and out.shape == (3, side, side) and out.dtype == np.float32
                     and bool(np.isfinite(out).all())
                     and np.array_equal(out[:, far].view(np.uint32), img[:, far].view(np.uint32))
                     and float(np.abs(out - img)[:, mask > 0].mean()) > 1e-2)
    want_total = _want("serve")
    want_batch = {k: n // SERVE_BATCHES for k, n in want_total.items()}
    per_batch_ok = (len(batches) == SERVE_BATCHES
                    and all(_launches_ok(b["counted"], want_batch) for b in batches))
    seeds_differ = "a" in outs and "b" in outs and not np.array_equal(outs["a"], outs["b"])
    stats_ok = (stats["requests"] == 3 and stats["batches"] == SERVE_BATCHES
                and stats["padded_lanes"] == 1 and stats["errors"] == 1)
    prog_ok = (done_entry.get("done") is True and done_entry.get("step") == STEPS
               and len(done_entry.get("think_steps_done", [])) == STEPS
               and any(not d and s < STEPS for s, _, d in progress))
    bad_ok = answers["bad"][0] >= 400 and "image shape" in answers["bad"][1].get("error", "")
    ok = (all(checks.values()) and per_batch_ok and launches == telemetry.families(want_total)
          and seeds_differ and stats_ok and prog_ok and bad_ok and health == {"ok": True})
    lat = {n: round(answers[n][2], 3) for n in ("a", "b", "c", "bad")}
    batch_s = [round(b["seconds"], 3) for b in batches]
    overhead = {n: round(answers[n][2] - batches[i // 2]["seconds"], 3)
                for i, n in enumerate(("a", "b")) if len(batches) > i // 2}
    if len(batches) == SERVE_BATCHES:
        overhead["c"] = round(answers["c"][2] - batches[1]["seconds"], 3)
    fwd = PAIRS
    say(f"phase 21 serving: InpaintServer(batch_size=2, max_delay_s=1.5) + make_http_server, "
        f"SDXL-1024 LoRA-merged, default Variant (euler karras {STEPS} x think {THINK}, cfg 5 "
        f"batched: {fwd} UNet forwards at batch 4 a batch) | 3 requests + 1 bad in {wall:.3f} s: "
        f"client seconds {lat}, batches {batch_s} s = "
        f"{[round(1e3 * b / fwd, 2) for b in batch_s]} ms per forward, per request "
        f"{wall / 3:.3f} s; client minus batch (HTTP, base64, queue, batching window) "
        f"{overhead} s, of which the client's base64 + JSON encode {t_encode:.3f} s and decode "
        f"{t_decode:.3f} s a request; peak {peak_gb:.1f} GB | answers ok {checks} (shape, finite, "
        f"beyond-blend pixels bit-equal, repainted moved), seeds differ {seeds_differ}, bad "
        f"request HTTP {answers['bad'][0]} alone {bad_ok}, /stats {stats} {stats_ok}, /progress "
        f"polled {len(progress)} times, done {done_entry.get('done')} think_steps_done "
        f"{done_entry.get('think_steps_done')} {prog_ok} | card's kernels {launches} (want "
        f"{telemetry.families(want_total)}), per batch "
        f"{[b['counted']['card'] for b in batches]}, graphs replayed "
        f"{[b['counted']['replays'] for b in batches]} {per_batch_ok} on {smi} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 21 serving checks failed")
    return launches


def phase_info(smi: str) -> None:
    """`python -m lanpaint_tpu_torch info` in a subprocess: it exits 0 and
    names the card."""
    proc = subprocess.run([sys.executable, "-m", "lanpaint_tpu_torch", "info"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    name = torch.cuda.get_device_name(0)
    devices = next((ln for ln in proc.stdout.splitlines() if ln.startswith("devices:")), "")
    ok = proc.returncode == 0 and name in devices
    say(f"phase 1 CLI: python -m lanpaint_tpu_torch info exit {proc.returncode}, {devices} on "
        f"{smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the CLI's info failed: {proc.stdout}\n{proc.stderr}")


def phase_sd15(smi: str) -> dict:
    """Single-file SD1.5 at its published 512^2, full width: a seeded
    SD15_CONFIG UNet, CLIP-L and SD_VAE_CONFIG VAE exported under the SD1.x
    prefixes into one BF16 file and read back with `from_single_file` (its
    defaults): the family, every tensor bit-equal to its source, then the
    pipeline's call and `inpaint_image` on the source modules with the
    pipeline's prompt encodings, each with phase 7's checks, bit-equal to
    each other.  A 2-step warm-up call of the pipeline comes first, so both
    timed calls are warm."""
    den, module = zoo.build_sd15(device="cuda", param_dtype=torch.bfloat16, seed=5)
    clip = zoo.build_clip(textenc.CLIP_L_CONFIG, device="cuda", param_dtype=torch.bfloat16,
                              seed=6)
    model = zoo.build_vae(vae.SD_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=7)
    parts = [("model.diffusion_model.",
              load.export_unet(module.state_dict(), unet.SD15_CONFIG, prefix="")),
             ("first_stage_model.", load.export_vae(model.state_dict(), vae.SD_VAE_CONFIG)),
             ("cond_stage_model.transformer.",
              load.export_clip(clip.state_dict(), textenc.CLIP_L_CONFIG))]
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pipe, loaded = _single_file("phase 13", parts, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del parts
    same = {"unet": _same_weights(pipe.model.module, module), "vae": _same_weights(pipe.vae, model),
            "clip_l": _same_weights(pipe.encoders["clip_l"].module, clip)}
    image, _ = _pixel_image(512)
    t0 = time.perf_counter()  # SD1.5's first run on the card: a 2-step warm-up call
    pipe(PROMPT, image=image, mask=_centre_mask(512, 512), blend_overlap=BLEND,
         **{**PIXEL_KW, "steps": 2})
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    ok, launches, text_, out = _pixel_workflow(_pipe_entry(pipe), None, None, image, "sd15",
                                               **PIXEL_KW)
    conds = dict(positive=pipe.encode(PROMPT), negative=pipe.encode(""))
    ok_ref, _, text_ref, reference = _pixel_workflow(inpaint_image, den, model, image, "sd15",
                                                     **conds, **PIXEL_KW)
    equal = torch.equal(out, reference)
    ok = (ok and ok_ref and equal and pipe.family == "sd15" and sorted(pipe.encoders) == ["clip_l"]
          and all(same.values()) and tuple(conds["positive"]["context"].shape) == (1, 77, 768))
    say(f"phase 13 single-file SD1.5 at 512^2: {loaded} | family {pipe.family}, bit-equal to the "
        f"sources {same} | pipeline call, euler karras {STEPS} x think {THINK}, cfg 5 "
        f"sequential, blend {BLEND}, first run (2 steps) {t_first:.2f} s, warm: {text_} | inpaint_image on the sources: {text_ref} | "
        f"outputs bit-equal {equal} on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 13 single-file SD1.5 failed its checks")
    return launches


def phase_t5(smi: str) -> None:
    """The T5 text encoders at full width, one at a time in fp32 (seeded
    random weights made on the card): T5_XXL_CONFIG (Flux, SD3) and
    UMT5_XXL_CONFIG (Wan) encode one prompt at 512 tokens through
    `NativeEncoder`: (1, 512, 4096), finite, timed (median of 3)."""
    for name, cfg, seed in (("T5-XXL", textenc.T5_XXL_CONFIG, 8),
                            ("UMT5-XXL", textenc.UMT5_XXL_CONFIG, 9)):
        t0 = time.perf_counter()
        module = zoo.build_t5(cfg, device="cuda", seed=seed)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in module.parameters())
        enc = text.NativeEncoder("t5", module, cfg, _synthetic_unigram(cfg.vocab_size))
        out = enc(PROMPT, 512)
        ms = median_ms(lambda: enc(PROMPT, 512), n=3, warmup=1)
        ok = tuple(out.shape) == (1, 512, 4096) and bool(torch.isfinite(out).all())
        say(f"phase 14 {name}: {n_params / 1e9:.3f} B params fp32 (init {t_init:.1f} s), one "
            f"prompt at 512 tokens -> {tuple(out.shape)} finite, {ms / 1e3:.4f} s (median of 3) "
            f"on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 14 {name} failed its checks")
        del module, enc, out
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phases 15-16: Z-Image and Qwen-Image-Edit (the Llama / Qwen text stack and
# the Qwen2.5-VL vision tower)

# Qwen's special tokens (Qwen2.5-VL's and Qwen3's tokenizer.json added_tokens)
QWEN_REGULAR = 151643
QWEN_SPECIAL = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
                "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
                "<|image_pad|>", "<|video_pad|>")
EDIT_SIDE = 1024  # the source image's side; the vision tower sees it at smart_resize's
Z_KW = dict(seed=0, steps=Z_STEPS, cfg=1.0, scheduler="simple", num_steps=THINK)
QWEN_KW = dict(seed=0, steps=STEPS, cfg=1.0, scheduler="simple", num_steps=THINK)


def synthetic_qwen_tokenizer() -> tokenizers.BpeTokenizer:
    """A byte-level BPE of Qwen's vocabulary size (`synthetic_bpe`): 151,643
    regular entries and the special tokens at Qwen's ids (<|endoftext|>
    151643 ... <|image_pad|> 151655)."""
    return synthetic_bpe(QWEN_REGULAR, QWEN_SPECIAL)


def synthetic_bpe(n_regular: int, special) -> tokenizers.BpeTokenizer:
    """A byte-level BPE of `n_regular` regular entries, the 256 byte symbols
    and merges over a-z (two letters, a space-prefixed letter, three letters,
    space-prefixed pairs, four letters, in rank order), then the `special`
    tokens from id `n_regular` on."""
    byte_enc = tokenizers.bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(sorted(byte_enc.values()))}
    space = byte_enc[ord(" ")]
    merges = []
    pairs = itertools.chain(
        itertools.product(LETTERS, LETTERS), ((space, a) for a in LETTERS),
        ((a + b, c) for a, b, c in itertools.product(LETTERS, LETTERS, LETTERS)),
        ((space + a, b) for a, b in itertools.product(LETTERS, LETTERS)),
        ((a + b + c, d) for a, b, c, d in itertools.product(*[LETTERS] * 4)))
    for a, b in pairs:
        if len(vocab) == n_regular:
            break
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    added = {t: n_regular + i for i, t in enumerate(special)}
    return tokenizers.BpeTokenizer(vocab, merges, added_tokens=added)


def _vision_tokens(cfg=vision.QWEN25_VL_VISION_CONFIG, side=EDIT_SIDE) -> int:
    """Merged vision tokens of a side x side image (smart_resize's grid)."""
    h, w = vision.smart_resize(side, side, cfg.patch_size * cfg.spatial_merge_size)
    return (h // cfg.patch_size) * (w // cfg.patch_size) // cfg.merge_unit


def text_lengths(tok) -> tuple:
    """(Z-Image's context tokens: the prompt alone, Qwen-Image-Edit's: the
    edit template with the image's vision tokens, less the 64 dropped)."""
    ids = tok.encode(text.QWEN_IMAGE_EDIT_TEMPLATE.format(PROMPT))
    return len(tok.encode(PROMPT)), len(ids) - 1 + _vision_tokens() - text.QWEN_EDIT_DROP_PREFIX


def add_new_path_shapes(z_txt: int, q_txt: int) -> None:
    """Phase 3's rows at the Z-Image and Qwen-Image-Edit shapes."""
    zs, qs = z_txt + 4096, q_txt + 8192
    ATTN_SHAPES.extend([
        ((1, 4096, 30, 128), {"zimage": 2}, SPLASH),    # the noise refiner
        ((1, zs, 30, 128), {"zimage": 30}, SPLASH),     # the main layers
        ((1, qs, 24, 128), {"qwen_edit": 60}, SPLASH),  # with 4,096 reference tokens
    ])
    WIDE_SHAPES.append(((1, 16384, 1, 384), {"qwen_edit": 3}, SPLASH_VIDEO))  # Wan2.1 at T = 1
    NORM_SHAPES.extend([
        ((1, zs, 3840), "rmsnorm", {"zimage": 120}),
        ((1, 4096, 3840), "rmsnorm", {"zimage": 9}),  # the noise refiner and norm_final
        ((1, z_txt, 3840), "rmsnorm", {"zimage": 8}),
        ((1, z_txt, 2560), "rmsnorm_fp32", {"zimage": 1}),  # cap_norm on the Qwen3 states
        ((1, zs, 30, 128), "rmsnorm", {"zimage": 60}),
        ((1, 4096, 30, 128), "rmsnorm", {"zimage": 4}),
        ((1, z_txt, 30, 128), "rmsnorm", {"zimage": 4}),
        ((1, q_txt, 3584), "rmsnorm", {"qwen_edit": 1}),  # txt_norm
        ((1, 8192, 24, 128), "rmsnorm_rope", {"qwen_edit": 120}),
        ((1, q_txt, 24, 128), "rmsnorm_rope", {"qwen_edit": 120}),
        ((1, 8192, 3072), "layernorm_na", {"qwen_edit": 120}),
        ((1, q_txt, 3072), "layernorm_na", {"qwen_edit": 120}),
        ((1, 4096, 3072), "layernorm_na", {"qwen_edit": 1}),
    ])


def _params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def phase_zimage(smi: str, tok, z_txt: int) -> dict:
    """Z-Image-1024 (the reference's Z_image_Inpaint workflow) through
    `LanPaintPipeline.from_components(family="z-image")`: Z_IMAGE_S3_CONFIG,
    the Qwen3-4B trunk and the Flux VAE, each built on the card with random
    bf16 weights (seeds 0, 1, 4) and handed over as the state dicts their
    exporters give (the checkpoint layouts), the synthetic Qwen tokenizer;
    every loaded tensor bit-equal to its source; `pipe.encode` timed; one
    forward under torch.profiler; then `pipe(PROMPT, image=..., mask=...)`
    with the workflow's settings (euler "simple", 9 steps, cfg 1, 5 think
    steps), timed and counted with phase 7's checks."""
    t0 = time.perf_counter()
    _, src = zoo.build_zimage(device="cuda", param_dtype=torch.bfloat16, seed=0)
    trunk = zoo.build_llama(textenc.QWEN3_4B_CONFIG, device="cuda", param_dtype=torch.bfloat16,
                            seed=1)
    ae = zoo.build_vae(vae.FLUX_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=4)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = {"dit": _params(src), "qwen3-4b": _params(trunk), "vae": _params(ae)}
    states = dict(model=load.export_zimage(src.state_dict(), zimage.Z_IMAGE_S3_CONFIG),
                  llama=load.export_llama(trunk.state_dict(), textenc.QWEN3_4B_CONFIG),
                  vae=load.export_vae(ae.state_dict(), vae.FLUX_VAE_CONFIG))
    t0 = time.perf_counter()
    pipe = LanPaintPipeline.from_components(family="z-image", llama_tokenizer=tok,
                                            device="cuda", param_dtype=torch.bfloat16, **states)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = {"dit": _same_weights(pipe.model.module, src),
            "qwen3-4b": _same_weights(pipe.encoders["llama"].module, trunk),
            "vae": _same_weights(pipe.vae, ae)}
    del states, src, trunk, ae
    gc.collect()
    torch.cuda.empty_cache()
    cond = pipe.encode(PROMPT)
    enc_ms = median_ms(lambda: pipe.encode(PROMPT), n=3, warmup=1)
    ctx = cond["context"]
    image, _ = _pixel_image(1024)
    with torch.no_grad():
        latent = pipe.vae.encode(image)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: pipe.model.apply(latent, t_mid, cond))
    del latent
    ok, launches, text_, _ = _pixel_workflow(_pipe_entry(pipe), None, None, image, "zimage",
                                             **Z_KW)
    ok = (ok and all(same.values()) and pipe.family == "qwen3"
          and sorted(pipe.encoders) == ["llama"] and tuple(ctx.shape) == (1, z_txt, 2560)
          and bool(torch.isfinite(ctx).all()))
    say(f"phase 15 Z-Image path: from_components(z-image), params bf16 "
        f"{ {k: round(v / 1e9, 3) for k, v in n.items()} } B, init {t_init:.1f} s, "
        f"from_components {t_load:.2f} s, bit-equal to the sources {same} | encode (Qwen3-4B, "
        f"{z_txt} tokens) -> {tuple(ctx.shape)}, {enc_ms:.2f} ms (median of 3) | one forward at "
        f"t = 0.7 under torch.profiler (S = {z_txt} + 4096): {_profile_text(prof)} | pipeline "
        f"call, euler simple {Z_STEPS} x think {THINK}, cfg 1, blend {BLEND}: {text_} on {smi}")
    if not ok:
        raise AssertionError("phase 15 Z-Image path failed its checks")
    return launches


def _edit_entry(den, model, **kw):
    return edit_image(den, model, **kw)


def _source_pixels(image):
    """A (1, 3, H, W) image in [-1, 1] as the vision tower's (H, W, 3) in [0, 1]."""
    return (image[0].permute(1, 2, 0) + 1.0) / 2.0


def phase_qwen_edit(smi: str, tok, q_txt: int) -> dict:
    """Qwen-Image-Edit-1024 (the reference's Qwen_Image_Edit_2509 workflow):
    the Qwen2.5-VL-7B text trunk (fp32, seed 2) and vision tower (fp32, seed
    3) encode the prompt with the source image through
    `encode_prompt(family="qwen_edit")` and are released; then
    `build_qwen_image` (bf16, seed 4) and the Wan2.1-graph VAE at one frame
    (bf16, seed 5) run `api.edit_image` (the source's packed latents as
    4,096 reference tokens) with euler "simple", 20 steps, cfg 1, 5 think
    steps and shift 2.2, timed and counted with phase 7's checks."""
    gc.collect()
    torch.cuda.empty_cache()
    image, _ = _pixel_image(EDIT_SIDE)
    source = _source_pixels(image)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = textenc.QWEN25_7B_CONFIG
    llama = text.NativeEncoder("llama", zoo.build_llama(cfg, device="cuda", seed=2), cfg, tok)
    tower = text.VisionEncoder(zoo.build_vision(device="cuda", seed=3))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_enc = {"qwen2.5-7b": _params(llama.module), "vision": _params(tower.module)}
    encode = lambda: text.encode_prompt(PROMPT, family="qwen_edit", llama=llama,  # noqa: E731
                                        vision=tower, image=source)
    t0 = time.perf_counter()
    cond = encode()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    enc_ms = median_ms(encode, n=3, warmup=0)
    vis_ms = median_ms(lambda: tower(source), n=3, warmup=0)
    enc_peak = torch.cuda.max_memory_allocated() / 1e9
    ctx = cond["context"]
    grid = next(iter(tower._plans))
    enc_ok = tuple(ctx.shape) == (1, q_txt, cfg.dim) and bool(torch.isfinite(ctx).all())
    del llama, tower
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    den, module = zoo.build_qwen_image(device="cuda", param_dtype=torch.bfloat16, seed=4)
    model = pipeline._SingleFrameVAE(zoo.build_wan_vae(
        video_vae.QWEN_IMAGE_VAE_CONFIG, device="cuda", param_dtype=torch.bfloat16, seed=5))
    torch.cuda.synchronize()
    t_dit = time.perf_counter() - t0
    n_dit, n_vae = _params(module), _params(model)
    enc_vae_ms, dec_vae_ms, latent = _vae_times(model, image)
    if tuple(latent.shape) != (1, 16, 128, 128) or not bool(torch.isfinite(latent).all()):
        raise AssertionError(f"the Qwen-Image VAE encode gave {tuple(latent.shape)}, finite "
                             f"{bool(torch.isfinite(latent).all())}")
    t_mid = torch.tensor([0.7], device="cuda")
    ref_cond = dict(cond, ref_tokens=dit.pack_latent(latent, 2))
    prof = profile_forward(lambda: den.apply(latent, t_mid, ref_cond))
    del ref_cond, latent
    ok, launches, text_, _ = _pixel_workflow(_edit_entry, den, model, image, "qwen_edit",
                                             positive=cond, **QWEN_KW)
    ok = ok and enc_ok
    say(f"phase 16 Qwen-Image-Edit path: encoders fp32 "
        f"{ {k: round(v / 1e9, 3) for k, v in n_enc.items()} } B params, init {t_init:.1f} s | "
        f"encode_prompt(qwen_edit): image {EDIT_SIDE}^2 -> grid {grid} -> "
        f"{_vision_tokens()} vision tokens, context {tuple(ctx.shape)} finite {enc_ok}, first "
        f"call {t_first:.2f} s, then {enc_ms:.2f} ms (the vision tower alone {vis_ms:.2f} ms; "
        f"median of 3), encoders' peak {enc_peak:.1f} GB | Qwen-Image {n_dit / 1e9:.3f} B "
        f"params bf16 + Wan2.1-graph VAE ({n_vae / 1e6:.1f} M) at T = 1, init {t_dit:.1f} s | "
        f"VAE encode {enc_vae_ms:.2f} ms decode {dec_vae_ms:.2f} ms (median of 3) | one forward "
        f"at t = 0.7 under torch.profiler (S = {q_txt} + 8192): {_profile_text(prof)} | "
        f"edit_image, euler simple {STEPS} x think {THINK}, cfg 1, shift 2.2, blend {BLEND}: "
        f"{text_} on {smi}")
    if not ok:
        raise AssertionError("phase 16 Qwen-Image-Edit path failed its checks")
    del den, module, model
    return launches


SMALL_QWEN_DIT = dataclasses.replace(dit.QWEN_IMAGE_CONFIG, depth_double=2)
SMALL_QWEN_TEXT = dataclasses.replace(textenc.QWEN25_7B_CONFIG, layers=2)
SMALL_VL = dataclasses.replace(vision.QWEN25_VL_VISION_CONFIG, depth=2, fullatt_block_indexes=(1,))


def phase_qwen_components(smi: str, tok, q_txt: int) -> None:
    """`from_components(family="qwen", with_vision=True)` on the card at full
    width and a small depth (2 double blocks, 2 text layers, 2 vision
    blocks; random bf16 weights, seeds 6-9): the DiT in the diffusers
    layout (`export_qwen`), the text trunk and the vision tower in one llama
    state, the Wan2.1-graph VAE; every loaded tensor bit-equal to its
    source; `pipe.encode` with and without the image; a 2-step pipeline
    call with the image's edit conditioning, with phase 7's checks."""
    _, dit_src = zoo.build_dit(SMALL_QWEN_DIT, device="cuda", param_dtype=torch.bfloat16, seed=6)
    trunk = zoo.build_llama(SMALL_QWEN_TEXT, device="cuda", param_dtype=torch.bfloat16, seed=7)
    tower = zoo.build_vision(SMALL_VL, device="cuda", param_dtype=torch.bfloat16, seed=8)
    ae = zoo.build_wan_vae(video_vae.QWEN_IMAGE_VAE_CONFIG, device="cuda",
                           param_dtype=torch.bfloat16, seed=9)
    states = dict(model=load.export_qwen(dit_src.state_dict(), SMALL_QWEN_DIT),
                  llama={**load.export_llama(trunk.state_dict(), SMALL_QWEN_TEXT),
                         **load.export_qwen_vl_vision(tower.state_dict(), SMALL_VL)},
                  vae=load.export_wan_vae(ae.state_dict(), video_vae.QWEN_IMAGE_VAE_CONFIG))
    t0 = time.perf_counter()
    pipe = LanPaintPipeline.from_components(
        family="qwen", with_vision=True, model_config=SMALL_QWEN_DIT,
        llama_config=SMALL_QWEN_TEXT, vision_config=SMALL_VL, llama_tokenizer=tok,
        device="cuda", param_dtype=torch.bfloat16, **states)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = {"dit": _same_weights(pipe.model.module, dit_src),
            "text": _same_weights(pipe.encoders["llama"].module, trunk),
            "vision": _same_weights(pipe.encoders["vision"].module, tower),
            "vae": _same_weights(pipe.vae.module, ae)}
    del states, dit_src, trunk, tower, ae
    image, _ = _pixel_image(EDIT_SIDE)
    source = _source_pixels(image)
    plain, edit = pipe.encode(PROMPT)["context"], pipe.encode(PROMPT, image=source)["context"]
    ok, _, text_, _ = _pixel_workflow(_pipe_entry(pipe), None, None, image, "qwen_small",
                                      encode_kw={"image": source}, **{**QWEN_KW, "steps": 2})
    ok = (ok and all(same.values()) and pipe.family == "qwen"
          and sorted(pipe.encoders) == ["llama", "vision"] and tuple(edit.shape) == (1, q_txt, 3584)
          and plain.shape[1] < edit.shape[1] and bool(torch.isfinite(plain).all()))
    say(f"phase 16b Qwen-Image from_components(qwen, with_vision) at full width, depth 2 / 2 / 2: "
        f"load {t_load:.2f} s, bit-equal to the sources {same} | encode: text {tuple(plain.shape)}"
        f", with the image {tuple(edit.shape)} | pipeline call with the edit conditioning, 2 "
        f"steps x think {THINK}, cfg 1: {text_} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 16b Qwen-Image from_components failed its checks")


# --------------------------------------------------------------------------
# phases 5c and 17-19: SD3.5-Large, HiDream-I1 and HunyuanVideo

# Llama-3's special tokens (Llama-3.1's tokenizer.json added_tokens, ids
# 128000-128255)
LLAMA_REGULAR = 128000
LLAMA_SPECIAL = (("<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                  "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                  "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                  "<|eom_id|>", "<|eot_id|>", "<|python_tag|>")
                 + tuple(f"<|reserved_special_token_{i}|>" for i in range(3, 248)))
SD3_CONTEXT = 77 + 154  # CLIP-L|G's 77 tokens, then T5's 154 (encode_prompt's sd3 length)
HIDREAM_T5 = 128        # examples/hidream_inpaint.py's context length
# examples/sd35_inpaint.py: euler "simple", CFG 4.5 as two sequential passes
SD35_KW = dict(seed=0, steps=STEPS, cfg=4.5, scheduler="simple", num_steps=THINK,
               sequential_cfg=True)
# examples/hidream_inpaint.py and hunyuan_inpaint.py: euler "simple", cfg 1
FLOW_KW = dict(seed=0, cfg=1.0, sampler_name="euler", scheduler="simple", num_steps=THINK)


def synthetic_llama_tokenizer() -> tokenizers.BpeTokenizer:
    """A byte-level BPE of Llama-3.1's vocabulary size (`synthetic_bpe`):
    128,000 regular entries and the 256 special tokens at Llama-3's ids
    (<|begin_of_text|> 128000 ... <|eot_id|> 128009 ...)."""
    return synthetic_bpe(LLAMA_REGULAR, LLAMA_SPECIAL)


def a14_text_lengths(llama_tok) -> tuple:
    """(HiDream's Llama tokens: the prompt alone, HunyuanVideo's: the image
    template with the prompt, less the 36 cropped)."""
    hy = llama_tok.encode(text.HYVIDEO_IMAGE_TEMPLATE.format(PROMPT))
    return len(llama_tok.encode(PROMPT)), len(hy) - text.HYVIDEO_IMAGE_CROP


def add_a14_shapes(n_ll: int, n_hy: int) -> None:
    """Phase 3's rows at the SD3.5-Large, HiDream-I1 and HunyuanVideo shapes
    (a 4D row-norm input is the strided q / k view of a fused projection)."""
    s3, sh, sy = SD3_CONTEXT + 4096, HIDREAM_T5 + n_ll + 4096, 4096 + n_hy
    ATTN_SHAPES.extend([
        ((1, s3, 38, 64), {"sd35": 38}, SPLASH),     # the joint attention
        ((1, sh, 20, 128), {"hidream": 48}, SPLASH),  # double and single blocks
        ((1, sy, 24, 128), {"hyvideo": 60}, SPLASH),
        ((1, s3, 19, 64), {}, SPLASH),   # SD3.5-Large's and HiDream-I1's at tensor 2
        ((1, sh, 10, 128), {}, SPLASH),
    ])
    for shape, calls, _ in WIDE_SHAPES:
        if shape == (1, 16384, 1, 512):
            calls["sd35"] = 2  # the SD3 VAE's encode and decode
    NORM_SHAPES.extend([
        ((1, 4096, 38, 64), "rmsnorm", {"sd35": 76}),  # ln_q / ln_k of the x stream
        ((1, SD3_CONTEXT, 38, 64), "rmsnorm", {"sd35": 76}),  # and of the context
        ((1, 4096, 2560), "rmsnorm", {"hidream": 32}),  # double blocks, image q / k
        ((1, HIDREAM_T5 + n_ll, 2560), "rmsnorm", {"hidream": 32}),  # and text q / k
        ((1, sh, 2560), "rmsnorm", {"hidream": 64}),    # single blocks
        ((1, 4096, 3072), "layernorm_na", {"hyvideo": 41}),
        ((1, n_hy, 3072), "layernorm_na", {"hyvideo": 40}),
        ((1, sy, 3072), "layernorm_na", {"hyvideo": 40}),
        ((1, n_hy, 3072), "layernorm", {"hyvideo": 4}),  # the token refiner
        ((1, 4096, 24, 128), "rmsnorm", {"hyvideo": 40}),
        ((1, n_hy, 24, 128), "rmsnorm", {"hyvideo": 40}),
        ((1, sy, 24, 128), "rmsnorm", {"hyvideo": 80}),  # linear1's q / k
        ((1, 4096, 19, 64), "rmsnorm", {}),  # SD3.5-Large's x-stream ln_q at tensor 2
    ])


SMALL_SD3 = dataclasses.replace(sd3.SD35_LARGE_CONFIG, hidden=256, num_heads=4, depth=3,
                                dual_attn_layers=(0,), context_dim=64, vec_dim=32,
                                pos_embed_max=64)
SMALL_HIDREAM = dataclasses.replace(hidream.HIDREAM_I1_CONFIG, hidden=256, num_heads=2,
                                    depth_double=2, depth_single=2, ffn_dim=512, context_dim=64,
                                    llama_dim=64, vec_dim=32)
SMALL_HYVIDEO = dataclasses.replace(hyvideo.HUNYUAN_VIDEO_720P_CONFIG, hidden=256, num_heads=2,
                                    depth_double=2, depth_single=2, refiner_depth=1,
                                    context_dim=64, vec_dim=32)
SMALL_A14_LATENT = (1, 16, 96, 96)  # 48 x 48 = 2,304 image tokens


def phase_small_a14() -> None:
    """Phase 5's check on a small SD3 (hidden 256, D = 64, one
    dual-attention layer, CFG 4.5 sequential), a small HiDream (D = 128,
    the 4-expert MoE, a 3-layer Llama stack) and a small HunyuanVideo (D =
    128, one refiner block, a 4D latent as one frame), each on a 96 x 96
    latent: 2,304 image tokens, so every joint and dual self-attention takes
    the kernel, and every q / k RMS norm (and HunyuanVideo's LayerNorms) the
    row norm."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(SMALL_A14_LATENT, generator=gen)
    t = torch.tensor([0.7])
    r = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    cases = [
        ("SD3", zoo.build_sd3, SMALL_SD3, tuple({"context": r(1, 16, 64), "vec": r(1, 32)}
                                                for _ in range(2)),
         dict(cfg=4.5, sequential_cfg=True), ("attention", "rmsnorm")),
        ("HiDream", zoo.build_hidream, SMALL_HIDREAM,
         ({"context": r(1, 16, 64), "vec": r(1, 32), "llama": r(3, 1, 8, 64)}, None),
         dict(cfg=1.0), ("attention", "rmsnorm")),
        ("HunyuanVideo", zoo.build_hyvideo, SMALL_HYVIDEO,
         ({"context": r(1, 16, 64), "vec": r(1, 32), "guidance": torch.tensor([6.0])}, None),
         dict(cfg=1.0), ("attention", "layernorm", "rmsnorm")),
    ]
    for name, build, cfg, cond, sampler_kw, kernels in cases:
        models = _three_ways(build, cfg, seed=3)
        c0 = cond[0]

        def forward(mod, dev, _c=c0, _video=name == "HunyuanVideo"):
            xin = (x[:, :, None] if _video else x).to(dev)
            return mod(xin, t.to(dev), *(v.to(dev) for v in _c.values()))

        ok, ran = _small_reference(f"phase 5c small {name} reference", models, forward,
                                   sampler_kw, SMALL_A14_LATENT, cond,
                                   calculate_sigmas(models[0][0].sigma_table, "simple", 4))
        if not (ok and all(ran[k] for k in kernels)):
            raise AssertionError(f"the small {name} on the card is less accurate than the plain "
                                 "path or did not go through the kernels")


def _host_state(state: dict) -> dict:
    """A checkpoint state (views of a module's tensors on the card) copied
    to the host, so the module can go before the pipeline loads it."""
    return {k: v.detach().cpu() for k, v in state.items()}


def phase_sd35(smi: str, clip_files) -> dict:
    """SD3.5-Large-1024 from pixels through `LanPaintPipeline.from_
    components(family="sd35")` (examples/sd35_inpaint.py's settings): the
    SD35_LARGE_CONFIG MMDiT (bf16, seed 0), the SD3 VAE (bf16, seed 1) and
    CLIP-L, CLIP-G and T5-XXL (fp32, seeds 2-4) are built on the card one at
    a time, exported to checkpoint states on the host (the MMDiT under
    `model.diffusion_model.`, CLIP-G in the OpenCLIP layout) and released,
    then loaded with `encoder_dtype=torch.float32`; every loaded tensor
    bit-equal to its source (rebuilt from its seed); `pipe.encode` timed;
    one forward under torch.profiler; then the pipeline's call: euler
    "simple", 20 steps x 5 think, CFG 4.5 as two sequential passes, a
    centre mask, timed and counted with phase 7's checks (the SD3 VAE's mid
    attention, D = 512, exactly twice)."""
    sources = {  # component: (builder, seed, exporter)
        "model": (lambda: zoo.build_sd35_large(device="cuda", param_dtype=torch.bfloat16,
                                               seed=0)[1],
                  lambda m: load.export_sd3(m.state_dict(), sd3.SD35_LARGE_CONFIG)),
        "vae": (lambda: zoo.build_vae(vae.SD3_VAE_CONFIG, device="cuda",
                                      param_dtype=torch.bfloat16, seed=1),
                lambda m: load.export_vae(m.state_dict(), vae.SD3_VAE_CONFIG)),
        "clip_l": (lambda: zoo.build_clip(textenc.CLIP_L_CONFIG, device="cuda", seed=2),
                   lambda m: load.export_clip(m.state_dict(), textenc.CLIP_L_CONFIG)),
        "clip_g": (lambda: zoo.build_clip(textenc.CLIP_G_CONFIG, device="cuda", seed=3),
                   lambda m: _hf_to_openclip(load.export_clip(m.state_dict(),
                                                              textenc.CLIP_G_CONFIG),
                                             textenc.CLIP_G_CONFIG.layers)),
        "t5": (lambda: zoo.build_t5(textenc.T5_XXL_CONFIG, device="cuda", seed=4),
               lambda m: load.export_t5(m.state_dict(), textenc.T5_XXL_CONFIG)),
    }
    t0 = time.perf_counter()
    states, n = {}, {}
    for name, (build, export) in sources.items():
        module = build()
        n[name] = _params(module)
        states[name] = _host_state(export(module))
        del module
    torch.cuda.empty_cache()
    t_export = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = LanPaintPipeline.from_components(
        family="sd35", clip_vocab=clip_files[0], clip_merges=clip_files[1],
        t5_tokenizer=_synthetic_unigram(textenc.T5_XXL_CONFIG.vocab_size), device="cuda",
        param_dtype=torch.bfloat16, encoder_dtype=torch.float32, **states)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del states
    gc.collect()
    loaded = {"model": pipe.model.module, "vae": pipe.vae,
              **{k: pipe.encoders[k].module for k in ("clip_l", "clip_g", "t5")}}
    same = {}
    for name, (build, _) in sources.items():
        source = build()
        same[name] = _same_weights(loaded[name], source)
        del source
        torch.cuda.empty_cache()
    cond = pipe.encode(PROMPT)
    enc_ms = median_ms(lambda: pipe.encode(PROMPT), n=3, warmup=1)
    ctx, vec = cond["context"], cond["vec"]
    enc_ok = (tuple(ctx.shape) == (1, SD3_CONTEXT, 4096) and tuple(vec.shape) == (1, 2048)
              and bool(torch.isfinite(ctx).all()) and bool(torch.isfinite(vec).all()))
    image, _ = _pixel_image(1024)
    with torch.no_grad():
        latent = pipe.vae.encode(image)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: pipe.model.apply(latent, t_mid, cond))
    lat_shape = tuple(latent.shape)
    del latent
    ok, launches, text_, _ = _pixel_workflow(_pipe_entry(pipe), None, None, image, "sd35",
                                             **SD35_KW)
    ok = (ok and enc_ok and all(same.values()) and pipe.family == "sd3"
          and sorted(pipe.encoders) == ["clip_g", "clip_l", "t5"]
          and lat_shape == (1, 16, 128, 128))
    say(f"phase 17 SD3.5-Large path: from_components(sd35), params "
        f"{ {k: round(v / 1e9, 3) for k, v in n.items()} } B (the MMDiT and the VAE bf16, the "
        f"encoders fp32), built and exported to the host {t_export:.1f} s, from_components "
        f"{t_load:.2f} s, bit-equal to the sources {same} | encode (CLIP-L, CLIP-G, T5-XXL) -> "
        f"context {tuple(ctx.shape)} vec {tuple(vec.shape)} finite {enc_ok}, {enc_ms:.2f} ms "
        f"(median of 3) | latent {lat_shape} | one forward at t = 0.7 under torch.profiler (S = "
        f"{SD3_CONTEXT} + 4096): {_profile_text(prof)} | pipeline call, euler simple {STEPS} x "
        f"think {THINK}, cfg 4.5 sequential, blend {BLEND}: {text_} on {smi}")
    if not ok:
        raise AssertionError("phase 17 SD3.5-Large path failed its checks")
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(lat_shape, device="cuda", generator=gen)
    _tp_check("phase 24a SD3.5-Large", "sd35", smi,
              lambda st, **kw: zoo.build_sd35_large(st, tp_axis="tensor", layer_axis="data",
                                                    **kw),
              pipe.model.module.state_dict(), pipe.model, x, t_mid, cond)
    del pipe, loaded
    return launches


def _encoders(clip_files, llama_tok, names) -> dict:
    """fp32 NativeEncoders on the card with seeded random weights: `names`
    of t5 (T5-XXL), clip_l, clip_g and llama (Llama-3.1-8B)."""
    clip_tok = tokenizers.ClipBpeTokenizer.from_files(*clip_files)
    specs = {"t5": ("t5", zoo.build_t5, textenc.T5_XXL_CONFIG, 10,
                    _synthetic_unigram(textenc.T5_XXL_CONFIG.vocab_size)),
             "clip_l": ("clip", zoo.build_clip, textenc.CLIP_L_CONFIG, 11, clip_tok),
             "clip_g": ("clip", zoo.build_clip, textenc.CLIP_G_CONFIG, 12, clip_tok),
             "llama": ("llama", zoo.build_llama, textenc.LLAMA31_8B_CONFIG, 13, llama_tok)}
    out = {}
    for name in names:
        kind, build, cfg, seed, tok = specs[name]
        out[name] = text.NativeEncoder(kind, build(cfg, device="cuda", seed=seed), cfg, tok)
    return out


def _encode_phase(clip_files, llama_tok, names, encode) -> tuple:
    """Build the fp32 encoders `names`, encode with `encode(encoders)`
    (first call, then the median of 3), release them: (cond, params by
    encoder, init s, first call s, ms, the encoders' peak GB)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    encs = _encoders(clip_files, llama_tok, names)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = {k: _params(e.module) for k, e in encs.items()}
    t0 = time.perf_counter()
    cond = encode(encs)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    ms = median_ms(lambda: encode(encs), n=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del encs
    gc.collect()
    torch.cuda.empty_cache()
    return cond, n, t_init, t_first, ms, peak


def _latent_phase(label, path, smi, build, cond, enc_text, tp=None) -> dict:
    """Build the DiT (bf16, seed 5), one forward at t = 0.7 under
    torch.profiler, then `api.ksampler` (euler "simple", cfg 1, 20 steps x
    5 think, a centre mask) on a random (1, 16, 128, 128) latent after a
    2-step warm-up: `_main_path`'s checks; then `tp(den, module, latent,
    t)` (phase 24a) while the weights are resident."""
    t0 = time.perf_counter()
    den, module = build(device="cuda", param_dtype=torch.bfloat16, seed=5)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(6)
    latent = torch.randn((1, 16, 128, 128), device="cuda", generator=gen)
    t_mid = torch.tensor([0.7], device="cuda")
    prof = profile_forward(lambda: den.apply(latent, t_mid, cond))
    say(f"{label}: {enc_text} | one forward at t = 0.7 under torch.profiler: "
        f"{_profile_text(prof)} on {smi}")

    def run(steps=STEPS):
        return api.ksampler(den, positive=cond, latent=latent, mask=_centre_mask(1024, 1024),
                            steps=steps, **FLOW_KW)

    launches = _main_path(f"{label}: ksampler, euler simple {STEPS} x think {THINK}, cfg 1 "
                          "(warm-up: 2 steps)", path, smi, den, module, t_init, run,
                          lambda: run(2), latent)
    if tp is not None:
        tp(den, module, latent, t_mid)
    del den, module
    return launches


def phase_hidream(smi: str, clip_files, llama_tok, n_ll: int) -> dict:
    """HiDream-I1-1024 latent path: `encode_prompt(family="hidream")` with
    fp32 T5-XXL (128 tokens), CLIP-L, CLIP-G (the pooled vec's second
    half) and the LLAMA31_8B_CONFIG trunk, released; then
    `build_hidream` at HIDREAM_I1_CONFIG through `_latent_phase`."""
    def encode(encs):
        return text.encode_prompt(PROMPT, family="hidream", t5_length=HIDREAM_T5, **encs)

    cond, n, t_init, t_first, ms, peak = _encode_phase(
        clip_files, llama_tok, ("t5", "clip_l", "clip_g", "llama"), encode)
    shapes = {k: tuple(v.shape) for k, v in cond.items()}
    want = {"context": (1, HIDREAM_T5, 4096), "vec": (1, 2048), "llama": (32, 1, n_ll, 4096)}
    if shapes != want or not all(bool(torch.isfinite(v).all()) for v in cond.values()):
        raise AssertionError(f"phase 18 HiDream encode gave {shapes} (want {want})")
    enc_text = (f"encode_prompt(hidream): encoders fp32 "
                f"{ {k: round(v / 1e9, 3) for k, v in n.items()} } B params, init {t_init:.1f} s, "
                f"cond {shapes} finite, first call {t_first:.2f} s, then {ms:.2f} ms (median of "
                f"3), encoders' peak {peak:.1f} GB, released")
    def tp(den, module, latent, t):
        _tp_check("phase 24a HiDream-I1", "hidream", smi,
                  lambda st, **kw: zoo.build_hidream(None, st, tp_axis="tensor",
                                                     expert_axis="expert", layer_axis="data", **kw),
                  module.state_dict(), den, latent, t, cond)

    return _latent_phase("phase 18 HiDream-I1 path", "hidream", smi, zoo.build_hidream, cond,
                         enc_text, tp=tp)


def phase_hyvideo(smi: str, clip_files, llama_tok, n_hy: int) -> dict:
    """HunyuanVideo-720p as a single-frame 1024^2 T2I (the reference's
    Hunyuan workflow, examples/hunyuan_inpaint.py): `encode_prompt(family=
    "hyvideo")` with the image template (36 states cropped), the fp32
    LLAMA31_8B_CONFIG trunk and CLIP-L, released; guidance 6.0; then
    `build_hyvideo` at HUNYUAN_VIDEO_720P_CONFIG through `_latent_phase`
    (the 4D latent runs as one frame)."""
    def encode(encs):
        return text.encode_prompt(PROMPT, family="hyvideo", **encs)

    cond, n, t_init, t_first, ms, peak = _encode_phase(clip_files, llama_tok,
                                                       ("clip_l", "llama"), encode)
    shapes = {k: tuple(v.shape) for k, v in cond.items()}
    want = {"context": (1, n_hy, 4096), "vec": (1, 768)}
    if shapes != want or not all(bool(torch.isfinite(v).all()) for v in cond.values()):
        raise AssertionError(f"phase 19 HunyuanVideo encode gave {shapes} (want {want})")
    cond["guidance"] = torch.tensor([6.0], device="cuda")
    enc_text = (f"encode_prompt(hyvideo): encoders fp32 "
                f"{ {k: round(v / 1e9, 3) for k, v in n.items()} } B params, init {t_init:.1f} s, "
                f"cond {shapes} finite, first call {t_first:.2f} s, then {ms:.2f} ms (median of "
                f"3), encoders' peak {peak:.1f} GB, released; guidance 6.0")
    return _latent_phase("phase 19 HunyuanVideo path", "hyvideo", smi, zoo.build_hyvideo, cond,
                         enc_text)


def _sp_forward_checks(smi, cfg, state, wan_den, sp, x, t, cond) -> None:
    """Phase 22's forward: `build_wan`'s (bf16, the flash kernel) and the
    seq-parallel one (bf16, ring attention), each against `build_wan` in
    fp32 on the same weights with plain fp32 attention (`_plain_attention`
    in place of `wan.attention_bshd`: fp32 GEMMs, fp32 norms, no ring, no
    row-parallel reduce, no frame offset); the seq-parallel error within
    twice `build_wan`'s."""
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32, residual_dtype=None)
    ref, _ = zoo.build_wan(ref_cfg, state, device="cuda")
    routed = wan.attention_bshd
    wan.attention_bshd = lambda q, k, v, scale=None: _plain_attention(q, k, v)
    try:
        want = ref.apply(x, t, cond).float()
    finally:
        wan.attention_bshd = routed
    del ref
    outs = {"wan": wan_den.apply(x, t, cond).float(), "sp": sp.apply(x, t, cond).float()}
    errs = {k: (float((o - want).abs().max()), rel_l2(o, want)) for k, o in outs.items()}
    ms = {k: median_ms(lambda d=d: d.apply(x, t, cond), n=3, warmup=1)
          for k, d in (("wan", wan_den), ("sp", sp))}
    ok = bool(torch.isfinite(want).all()) and all(
        bool(torch.isfinite(o).all()) for o in outs.values()) and all(
        errs["sp"][i] <= 2 * errs["wan"][i] for i in (0, 1))
    say(f"phase 22 parallel path: one forward at t = {float(t[0]):.1f}, x {tuple(x.shape)}: "
        f"build_wan_seq_parallel (ring) {ms['sp']:.2f} ms, build_wan (flash kernel) "
        f"{ms['wan']:.2f} ms (median of 3) on {smi} | against build_wan in fp32 with plain "
        f"attention: seq-parallel max abs {errs['sp'][0]:.4g} rel_l2 {errs['sp'][1]:.4g}, "
        f"build_wan max abs {errs['wan'][0]:.4g} rel_l2 {errs['wan'][1]:.4g} (limit twice "
        f"build_wan's) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 22 seq-parallel forward check failed")


def _sp_ring_checks(smi, group) -> dict:
    """Phase 22's ring: `ring_attention` at TI2V-5B's (1, 7920, 24, 128) over
    a group of one, against the flash kernel (row 2) and an fp32 reference
    (`_plain_attention`); device times of the ring, the kernel and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    q, k, v = _qkv_views(1, 7920, 24, 128, gen)
    ring = parallel.ring_attention(q, k, v, group).float()
    kern = attention.flash_attention(q, k, v).float()
    want = _plain_attention(q.float(), k.float(), v.float())
    err_ring, err_kern = (float((o - want).abs().max()) for o in (ring, kern))
    del ring, kern, want
    us = {"ring": device_us(lambda: parallel.ring_attention(q, k, v, group)),
          "kernel": device_us(lambda: attention.flash_attention(q, k, v)),
          "sdpa": device_us(lambda: _sdpa(q, k, v))}
    ok = err_ring <= 2 * err_kern
    say(f"phase 22 parallel path: ring_attention (1, 7920, 24, 128) bf16 over a group of one: "
        f"max abs err from fp32 {err_ring:.3g} (the flash kernel's {err_kern:.3g}, limit twice) "
        f"| device us: ring {us['ring']:.1f}, flash kernel {us['kernel']:.1f}, "
        f"scaled_dot_product_attention {us['sdpa']:.1f} on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 22 ring attention check failed")
    return us


def phase_parallel(smi: str) -> dict:
    """The parallel path at a world of one over NCCL (`parallel.init_world`:
    a file store in a temporary directory, the group destroyed and the
    directory removed at the end): the mesh, TI2V-5B at full width (random
    bf16 weights, seed 0) at the video path's latent (1, 48, 9, 44, 80),
    S = 7,920, through `build_wan_seq_parallel(..., tp_axis="tensor")`: one
    forward held against `build_wan`'s on the same weights, then a counted
    2-step, 2-think euler LanPaintSampler run (finite, the known region
    equal to the latent), then the ring against the flash kernel; the A14B
    pair's bytes per device by tensor size, computed from a meta-device
    state."""
    with parallel.init_world("cuda"):
        mesh = parallel.make_mesh(parallel.MeshSpec(), "cuda")
        if tuple(mesh.shape) != (1, 1, 1, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"phase 22 mesh {mesh} on {dist.get_backend()}")
        cfg = wan.WAN22_TI2V_5B_CONFIG
        wan_den, module = zoo.build_wan(cfg, device="cuda", param_dtype=torch.bfloat16, seed=0)
        state = module.state_dict()
        t0 = time.perf_counter()
        sp, sp_module = zoo.build_wan_seq_parallel(cfg, state, mesh, tp_axis="tensor",
                                                   param_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(7)
        latent = torch.randn((1, 48, 9, 44, 80), device="cuda", generator=gen)
        cond = {"context": torch.randn((1, 512, 4096), device="cuda", generator=gen)}
        _sp_forward_checks(smi, cfg, state, wan_den, sp, latent,
                           torch.tensor([0.7], device="cuda"), cond)
        del wan_den, module, state
        gc.collect()
        torch.cuda.empty_cache()

        sam = LanPaintSampler(sp, config=LanPaintConfig(n_steps=SP_THINK), sampler_name="euler",
                              cfg=1.0)
        sigmas = calculate_sigmas(sp.sigma_table, "simple", SP_STEPS)
        mask = _centre_mask(44, 80)
        _zero_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        samples, _ = sam(latent=latent, sigmas=sigmas, cond=cond, mask=mask, seed=0, video=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        known = (mask == 0).expand_as(latent)
        finite = bool(torch.isfinite(samples).all())
        known_err = float((samples - latent)[known].abs().max())
        moved = float((samples - latent)[~known].abs().mean())
        want = _want("parallel")
        cross, cross_want, cross_ok = _cross_ok("parallel")
        ok = finite and known_err <= 1e-3 and moved > 1e-2 and launches == want and cross_ok
        axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        say(f"phase 22 parallel path: LanPaintSampler over build_wan_seq_parallel (mesh {axes}, "
            f"{dist.get_backend()}), euler simple {SP_STEPS} x think {SP_THINK}, cfg 1, "
            f"{FORWARDS['parallel']} forwards, init {t_init:.1f} s | run {wall:.3f} s = "
            f"{1e3 * wall / FORWARDS['parallel']:.2f} ms per forward, peak {peak:.1f} GB on "
            f"{smi} | finite {finite} known-region max err {known_err:.3g} repainted mean "
            f"change {moved:.3g} | launches {launches} (want {want}), cross-attention "
            f"launches {cross} (want {cross_want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 22 parallel sampler check failed")
        del sam, sp, sp_module, samples
        gc.collect()
        torch.cuda.empty_cache()

        _sp_ring_checks(smi, mesh.get_group("seq"))
        with torch.device("meta"):
            shapes = wan.WanModel(wan.WAN22_T2V_14B_CONFIG).state_dict()
        plan = {n: 2 * parallel.tp_plan_bytes(shapes, parallel.wan_tp_rules(), {"tensor": n})
                / 2**30 for n in (1, 2, 4, 8)}
        say("phase 22 parallel path: the T2V-A14B pair's bf16 weights per device under the Wan "
            f"tensor rules, computed (not measured): "
            + ", ".join(f"tensor {n}: {gib:.2f} GiB" for n, gib in plan.items()))
    if dist.is_initialized():
        raise AssertionError("phase 22: the world of one outlived its context")
    return launches


# phase 24a: a mesh build's forward at a world of one against the phase's
# own forward on the same bf16 weights, the model term (x - x0 = s * eps or
# t * v) compared: the row-parallel layers add their bias after the (here
# empty) reduce, one more bf16 rounding than the fused addmm, so the two
# need not be bit-equal (they are with the seeded weights' zero biases); a
# fault in a layer's layout or a missed reduce is an error of order one
TP_REL_L2 = 5e-2
TP_JOIN_S = 600  # phase 24b: the two ranks, start to join


def _model_term(den, x, t, cond):
    """x - den.apply(x, t, cond) in fp32: s * eps, or t * v."""
    return (x - den.apply(x, t, cond)).float()


def _tp_check(label, path, smi, build, state, den, x, t, cond, after=None) -> None:
    """Phase 24a inside a phase whose weights are resident: a world of one
    over NCCL (`parallel.init_world("cuda")`, mesh (1, 1, 1, 1)), the
    phase's family built through its zoo builder with `mesh=` from the
    phase's own state dict (every parameter a view of it: no second copy),
    one forward against the phase's own (the model term's relative L2 within
    TP_REL_L2, finite), the kernels launched exactly as a forward of the
    phase's path launches them; then `after(mesh)`."""
    want = _model_term(den, x, t, cond)
    with parallel.init_world("cuda"):
        mesh = parallel.make_mesh(parallel.MeshSpec(), "cuda")
        if tuple(mesh.shape) != (1, 1, 1, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"{label}: mesh {mesh} on {dist.get_backend()}")
        t0 = time.perf_counter()
        tp_den, module = build(state, mesh=mesh, param_dtype=torch.bfloat16)
        t_build = time.perf_counter() - t0
        owned = {v.untyped_storage().data_ptr() for v in state.values()}
        shared = all(p.untyped_storage().data_ptr() in owned for p in module.parameters())
        _zero_counters()
        got = _model_term(tp_den, x, t, cond)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in COUNTERS.items()}
        want_launches = {k: PER_FORWARD[path].get(k, 0) for k in COUNTERS}
        err, finite = rel_l2(got, want), bool(torch.isfinite(got).all())
        ms = median_ms(lambda: tp_den.apply(x, t, cond), n=3, warmup=1)
        ok = finite and err <= TP_REL_L2 and launches == want_launches and shared
        say(f"{label}: {type(module).__name__} through the builder's mesh= (world of one, "
            f"{dist.get_backend()}), built in {t_build:.2f} s, every parameter a view of the "
            f"phase's weights {shared} | one forward {ms:.2f} ms (median of 3) against the "
            f"phase's own: model term rel_l2 {err:.3g} (limit {TP_REL_L2}), finite {finite} | "
            f"launches {launches} (want {want_launches}) on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} failed its checks")
        del tp_den, module, got
        if after is not None:
            after(mesh)
    if dist.is_initialized():
        raise AssertionError(f"{label}: the world of one outlived its context")


def _tp_inputs():
    """Phase 24b's latent, sigma and cond, made from a seed on the card (the
    same in every process)."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    latent = torch.randn((1, 4, 128, 128), device="cuda", generator=gen)
    cond = {"context": torch.randn((1, 77, 2048), device="cuda", generator=gen),
            "y": torch.randn((1, 2816), device="cuda", generator=gen)}
    return latent, torch.tensor([3.0], device="cuda"), cond


def _tp_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase 24b: a gloo world of TP_RANKS processes on cuda:0,
    SDXL-1024 built from seed 0 and cut to this rank's tensor shard (the
    rest dropped), its first forward, then LanPaintSampler (euler karras
    TP_STEPS x SP_THINK, cfg 1) timed and counted; the results saved."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=TP_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = parallel.make_mesh(parallel.MeshSpec(tensor=TP_RANKS), "cuda")
        t0 = time.perf_counter()
        den, module = zoo.build_unet(unet.SDXL_CONFIG, mesh=mesh, tp_axis="tensor",
                                     param_dtype=torch.bfloat16, seed=0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        latent, sigma, cond = _tp_inputs()
        first = _model_term(den, latent, sigma, cond)
        sam = LanPaintSampler(den, config=LanPaintConfig(n_steps=SP_THINK), sampler_name="euler",
                              cfg=1.0)
        sigmas = calculate_sigmas(den.sigma_table, "karras", TP_STEPS)
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, _ = sam(latent=latent, sigmas=sigmas, cond=cond, mask=_centre_mask(1024, 1024),
                         seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        result = {"first": first.cpu(), "samples": samples.cpu(), "latent": latent.cpu(),
                  "launches": {k: f.launches for k, f in COUNTERS.items()},
                  "wall": wall, "t_init": t_init, "params": _params(module),
                  "qkv": tuple(module.mid_attn.blocks[0].attn1.to_qkv.weight.shape),
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_tp_sdxl(smi: str, den) -> dict:
    """Phase 24a for SDXL (phase 6's weights) and phase 24b: TP_RANKS
    spawned processes on the one card (a gloo world, CUDA tensors: gloo
    stages each collective through the host), each running its tensor-2
    shard of SDXL-1024 (`_tp_rank`).  Checks: both ranks' samples and first
    forwards bit-equal; the first forward's model term against the same
    weights in fp32 with plain attention in this process
    (`_plain_attention` in place of layers.attention_bshd), its relative L2
    within twice the one-process bf16 forward's; each rank's launches
    exactly 70 attention (at 5 and 10 heads) and 210 LayerNorms a forward.
    Returns the two ranks' launches together."""
    latent, sigma, cond = _tp_inputs()
    _tp_check("phase 24a SDXL", "sdxl", smi,
              lambda st, **kw: zoo.build_unet(unet.SDXL_CONFIG, st, tp_axis="tensor",
                                              layer_axis="data", **kw),
              den.module.state_dict(), den, latent, sigma, cond)

    directory = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank, args=(r, os.path.join(directory, "store"), directory))
             for r in range(TP_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * TP_RANKS:
            raise AssertionError(f"phase 24b: rank exit codes {codes}, {len(hung)} killed after "
                                 f"{TP_JOIN_S} s")
        ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    t_spawn = time.perf_counter() - t0

    one = _model_term(den, latent, sigma, cond)
    ref_den, _ = zoo.build_unet(dataclasses.replace(unet.SDXL_CONFIG, dtype=torch.float32),
                                den.module.state_dict(), device="cuda",
                                param_dtype=torch.float32)
    routed = layers.attention_bshd
    layers.attention_bshd = lambda q, k, v, scale=None: _plain_attention(q, k, v)
    try:
        want = _model_term(ref_den, latent, sigma, cond)
    finally:
        layers.attention_bshd = routed
    del ref_den
    gc.collect()
    torch.cuda.empty_cache()
    err_one = rel_l2(one, want)
    err_tp = rel_l2(ranks[0]["first"].cuda(), want)
    same = all(torch.equal(r["samples"], ranks[0]["samples"])
               and torch.equal(r["first"], ranks[0]["first"]) for r in ranks)
    per_rank = {k: n * TP_RANK_FORWARDS for k, n in PER_FORWARD["tp"].items()}
    want_launches = {k: per_rank.get(k, 0) for k in COUNTERS}
    launches_ok = all(r["launches"] == want_launches for r in ranks)
    samples = ranks[0]["samples"].cuda()
    lat = ranks[0]["latent"].cuda()
    side = lat.shape[-1]  # the centre mask's known region at the latent's size
    known = torch.ones((side, side), dtype=torch.bool, device="cuda")
    known[side // 4:3 * side // 4, side // 4:3 * side // 4] = False
    finite = bool(torch.isfinite(samples).all())
    known_err = float((samples - lat)[..., known].abs().max())
    moved = float((samples - lat)[..., ~known].abs().mean())
    ok = (same and err_tp <= 2 * err_one and launches_ok and finite and known_err <= 1e-3
          and moved > 1e-2)
    fwd_ms = ", ".join(f"{1e3 * r['wall'] / TP_RANK_FORWARDS:.1f}" for r in ranks)
    run_s = ", ".join(f"{r['wall']:.2f}" for r in ranks)
    say(f"phase 24b tensor-parallel SDXL-1024: {TP_RANKS} ranks (gloo, CUDA tensors staged "
        f"through the host) on the one card {smi}, each {ranks[0]['params'] / 1e9:.3f} B params "
        f"bf16 (mid attn1 to_qkv {ranks[0]['qkv']}), built in "
        f"{max(r['t_init'] for r in ranks):.1f} s, peak {max(r['peak_gb'] for r in ranks):.1f} "
        f"GB a rank, {t_spawn:.1f} s spawn to join | {fwd_ms} ms a forward by rank (the "
        f"run's; one shared card, host-staged collectives: not a multi-card time) | first "
        f"forward against fp32 "
        f"with plain attention: rel_l2 {err_tp:.4g}, the one-process bf16 forward's "
        f"{err_one:.4g} (limit twice) | LanPaintSampler euler karras {TP_STEPS} x think "
        f"{SP_THINK}, cfg 1: {run_s} s by rank, samples "
        f"and first forwards bit-equal across ranks {same}, finite {finite} known-region max err "
        f"{known_err:.3g} repainted mean change {moved:.3g} | launches a rank "
        f"{ranks[0]['launches']} (want {want_launches}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 24b tensor-parallel SDXL failed its checks")
    return {k: sum(r["launches"][k] for r in ranks) for k in COUNTERS}


def phase_tp_plan(smi: str) -> None:
    """Phase 24c: bf16 bytes per device under the port's rules (head rule
    included), computed from meta-device state dicts (not measured): SDXL,
    Flux-dev, SD3.5-Large and HiDream-I1 at tensor 1, 2, 4, 8, and
    HiDream-I1 at expert 1, 2, 4 too."""
    cases = [("SDXL", unet.UNetModel, unet.SDXL_CONFIG, parallel.unet_tp_rules),
             ("Flux-dev", dit.MMDiT, dit.FLUX_DEV_CONFIG, parallel.dit_tp_rules),
             ("SD3.5-Large", sd3.SD3MMDiT, sd3.SD35_LARGE_CONFIG, parallel.sd3_tp_rules),
             ("HiDream-I1", hidream.HiDreamModel, hidream.HIDREAM_I1_CONFIG,
              parallel.hidream_ep_rules)]
    parts = []
    for name, cls, cfg, rules in cases:
        with torch.device("meta"):
            state = cls(cfg).state_dict()
        experts = (1, 2, 4) if cls is hidream.HiDreamModel else (1,)
        sizes = [(t, e) for e in experts for t in (1, 2, 4, 8)]
        gib = {(t, e): parallel.tp_plan_bytes(state, rules(cfg), {"tensor": t, "expert": e})
               / 2**30 for t, e in sizes}
        parts.append(f"{name}: " + ", ".join(
            f"tensor {t}{f' expert {e}' if len(experts) > 1 else ''} {g:.3f}"
            for (t, e), g in gib.items()))
    say("phase 24c bf16 weights per device (GiB) under the port's tensor / expert rules, the "
        "head rule included, computed (not measured): " + " | ".join(parts))


def _dp_fused_check(smi, sam, latent, sigmas, cond, mask):
    """After Flux's phase 24a, in its world of one: the fused path (the
    kernels' element offset rows.start * M = 0) through
    `parallel.with_data_parallel`, which no longer refuses it, bit-equal to
    the sampler's own run with the same seed."""
    def check(mesh):
        kw = dict(latent=latent, sigmas=sigmas, cond=cond, mask=mask, seed=0)
        dp = parallel.with_data_parallel(sam, mesh)
        t0 = time.perf_counter()
        got, _ = dp(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want, _ = sam(**kw)
        same = torch.equal(got, want)
        say(f"phase 24 data-parallel fused: Flux-dev's fused think step through "
            f"with_data_parallel at a world of one, euler simple {len(sigmas) - 1} x think "
            f"{THINK}: {wall:.2f} s, bit-equal to the sampler's own run {same} on {smi} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("phase 24 data-parallel fused run differs")
    return check


EXAMPLES = ("sdxl_inpaint", "sdxl_single_file", "flux_inpaint", "flux2_dev_inpaint",
            "flux2_klein_inpaint", "krea2_inpaint", "anima_inpaint", "sd35_inpaint",
            "hidream_inpaint", "hunyuan_inpaint", "z_image_inpaint", "qwen_image_edit",
            "qwen_image_outpaint", "ideogram4_dual_model", "wan22_video_inpaint", "serving_http",
            "wan22_seq_parallel")


@contextlib.contextmanager
def _recording(log: collections.Counter):
    """While open, every launch of the row-norm and attention kernels also
    counts its call in `log`, keyed by what the kernel sees: shapes,
    strides, dtypes, mode, eps or scale."""
    norm_launch, attn_launch = norms._launch, attention._tma_launch

    def norm(wrapper, x, gamma, beta, eps, rms, out_dtype, config=None, rope=None):
        before = wrapper.launches
        out = norm_launch(wrapper, x, gamma, beta, eps, rms, out_dtype, config, rope)
        if wrapper.launches > before:
            table = None if rope is None else (tuple(rope[0].shape), rope[0].stride(), rope[1])
            log[("row_norm", rms, tuple(x.shape), x.stride(), x.dtype,
                 None if gamma is None else gamma.dtype, beta is not None, eps, out.dtype,
                 table)] += 1
        return out

    def attn(op, entry, q, k, v, scale):
        out = attn_launch(op, entry, q, k, v, scale)
        log[(op, tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(), q.dtype,
             scale)] += 1
        return out

    norms._launch, attention._tma_launch = norm, attn
    try:
        yield
    finally:
        norms._launch, attention._tma_launch = norm_launch, attn_launch


def _random_strided(shape, stride, dtype, gen, scale=1.0, shift=0.0):
    """A tensor of `shape` and `stride` over a buffer of normals."""
    size = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    buf = (torch.randn(size, device=gen.device, generator=gen) * scale + shift).to(dtype)
    return buf.as_strided(shape, stride)


def _replay_norm(key, n, gen) -> dict:
    """One recorded row-norm call on fresh inputs of its layout, against its
    plain version (NORM_TOL), timed (reps 5, host-inclusive); a call with
    the RoPE epilogue also equal to `rmsnorm` + `apply_rope` on the card,
    which it is timed against."""
    _, rms, shape, stride, dtype, g_dtype, has_beta, eps, out_dtype, table = key
    c = shape[-1]
    x = _random_strided(shape, stride, dtype, gen, 2.0, 0.5)
    rnd = lambda: torch.randn(c, device=gen.device, generator=gen)  # noqa: E731
    g = None if g_dtype is None else (1.0 + 0.1 * rnd()).to(g_dtype)
    beta = (0.1 * rnd()).to(g_dtype) if has_beta else None
    lib_w = lambda t: None if t is None else t.to(x.dtype)  # noqa: E731
    library = library_name = freqs = None
    if table is not None:
        mode, (f_shape, f_stride, head_dim) = "rmsnorm_rope", table
        freqs = _random_strided(f_shape, f_stride, torch.float32, gen)
        kernel = lambda: norms.rmsnorm_rope(x, g, eps, freqs, head_dim)  # noqa: E731
        plain = lambda: norms.rmsnorm_rope_ref(x, g, eps, freqs, head_dim)  # noqa: E731
        library_name = "rmsnorm + apply_rope"
        library = lambda: norms.rope_rows(norms.rmsnorm(x, g, eps), freqs, head_dim)  # noqa: E731
        if not torch.equal(kernel(), library()):
            raise AssertionError(f"phase 23: rmsnorm_rope {shape} stride {stride} table "
                                 f"{f_shape} {f_stride} differs from rmsnorm + apply_rope")
    elif rms:
        mode = "rmsnorm_fp32" if dtype == torch.float32 else "rmsnorm"
        kernel, plain = (lambda: norms.rmsnorm(x, g, eps)), (lambda: norms.rmsnorm_ref(x, g, eps))
        library, library_name = (lambda: F.rms_norm(x, (c,), lib_w(g), eps=eps)), "F.rms_norm"
    else:
        mode = "layernorm" if g is not None else "layernorm_na"
        kw = dict(eps=eps, out_dtype=out_dtype)
        kernel = lambda: norms.layernorm(x, g, beta, **kw)  # noqa: E731
        plain = lambda: norms.layernorm_ref(x, g, beta, **kw)  # noqa: E731
        if g is not None and out_dtype == dtype:
            library_name = "F.layer_norm"
            library = lambda: F.layer_norm(x, (c,), lib_w(g), lib_w(beta), eps=eps)  # noqa: E731
    out = kernel()
    want = plain()
    err = float((out.float() - want.float()).abs().max())
    if not (out.dtype == want.dtype and torch.allclose(out.float(), want.float(), **NORM_TOL)):
        raise AssertionError(f"phase 23: {mode} {shape} stride {stride} {dtype} -> {out_dtype} "
                             f"disagrees with its plain version: max abs {err}")
    n_bytes = sum(t.numel() * t.element_size() for t in (x, out, g, beta, freqs)
                  if t is not None)
    return timed_row(kernel, plain, err, {}, run_calls={"examples": n}, reps=5, device=False,
                     bounds=bound(n_bytes, NORM_OPS[mode] * x.numel(), PEAK_FP32),
                     library=library, library_name=library_name, shape=shape, mode=mode)


def _replay_attention(key, n, gen) -> dict:
    """One recorded attention call on fresh inputs of its layout, against
    `attention_ref` in fp32 (ATTN_TOL), timed (reps 5, host-inclusive)."""
    op, q_shape, q_stride, k_shape, k_stride, v_stride, dtype, scale = key
    q = _random_strided(q_shape, q_stride, dtype, gen)
    k, v = (_random_strided(k_shape, st, dtype, gen) for st in (k_stride, v_stride))
    kernel = getattr(attention, op)
    out = kernel(q, k, v, scale)
    want = attention.attention_ref(q.float(), k.float(), v.float(), scale)
    err, rel = float((out.float() - want).abs().max()), rel_l2(out.float(), want)
    if not (err <= ATTN_TOL["max_abs"] and rel <= ATTN_TOL["rel_l2"]):
        raise AssertionError(f"phase 23: {op} {q_shape} disagrees with attention_ref: max abs "
                             f"{err}, rel L2 {rel}, limits {ATTN_TOL}")
    b, s, h, d = q_shape
    sk = k_shape[1]
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return timed_row(lambda: kernel(q, k, v, scale),
                     lambda: attention.attention_ref(q, k, v, scale), err, {},
                     run_calls={"examples": n}, reps=5, device=False,
                     bounds=bound(2 * (2 * b * s * h * d + 2 * b * sk * h * d),
                                  4 * b * h * s * sk * d, PEAK_BF16),
                     library=lambda: F.scaled_dot_product_attention(t(q), t(k), t(v),
                                                                    scale=scale),
                     library_name="scaled_dot_product_attention", shape=q_shape)


def phase_examples(smi: str) -> tuple:
    """The port's 17 example scripts in --smoke mode on the card (their
    default device), in this process through runpy as `python -m
    lanpaint_tpu_torch.examples.<name> --smoke` runs them (serving_http with
    --selftest, wan22_seq_parallel as a world of one over NCCL): each must
    exit 0 and report a finite output; wall time and launches by kernel of
    each.  Every distinct call of a kernel that they make (shapes, strides,
    dtypes, mode) is then made again on fresh inputs of its layout and held
    against the plain version at phase 3's tolerance; a launch of a kernel
    that is not replayed fails the phase.  Returns the launches of all of
    them and a kernels-line row per distinct call."""
    total = {k: 0 for k in COUNTERS}
    log = collections.Counter()
    for name in EXAMPLES:
        argv = ["--smoke"] + (["--selftest"] if name == "serving_http" else [])
        out = io.StringIO()
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code = 0
        saved = sys.argv
        sys.argv = [name] + argv
        try:
            with contextlib.redirect_stdout(out), _recording(log):
                runpy.run_module(f"lanpaint_tpu_torch.examples.{name}", run_name="__main__",
                                 alter_sys=False)
        except SystemExit as e:
            code = e.code or 0
        finally:
            sys.argv = saved
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in COUNTERS.items()}
        for k, n in launches.items():
            total[k] += n
        report = [line for line in out.getvalue().splitlines() if "finite=" in line]
        ok = code == 0 and bool(report) and all("finite=True" in line for line in report)
        used = {k: n for k, n in launches.items() if n}
        say(f"phase 23 examples: {name} {' '.join(argv)}: exit {code}, {wall:.2f} s, launches "
            f"{used} | {report[-1] if report else 'no report'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 23 example {name} failed:\n{out.getvalue()[-2000:]}")
        gc.collect()
    if not (total["layernorm"] and total["rmsnorm"] and total["rmsnorm_rope"]):
        raise AssertionError(f"phase 23: the row-norm kernel was not launched: {total}")
    if total["fused_half_step"] or total["fused_finish"]:
        raise AssertionError(f"phase 23: fused kernel launches are not replayed: {total}")
    say(f"phase 23 examples: all {len(EXAMPLES)} on {smi}, launches {total}")

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {"flash_attention": [], "wide_attention": [], "row_norm": []}
    for key, n in log.items():
        replay = _replay_norm if key[0] == "row_norm" else _replay_attention
        rows[key[0]].append(replay(key, n, gen))
    recorded = {k: sum(n for key, n in log.items() if key[0] == k) for k in rows}
    counted = {"flash_attention": total["flash_attention"],
               "wide_attention": total["wide_attention"],
               "row_norm": total["layernorm"] + total["rmsnorm"] + total["rmsnorm_rope"]}
    ok = recorded == counted
    say(f"phase 23 examples: each distinct kernel call made again on fresh inputs against its "
        f"plain version: " + ", ".join(
            f"{k} {len(r)} calls ({recorded[k]} launches), max abs err "
            f"{max((x['err'] for x in r), default=0.0):.3g}" for k, r in rows.items())
        + f" | recorded launches {recorded} (counted {counted}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 23: the recorded launches differ from the counters")
    return total, rows


def kernels_line(rows: dict, launches: dict) -> list:
    """One entry per kernel: launches in the timed main-path runs, and the
    per-launch times, bounds and library-call times at each main-path shape
    weighted by those runs' launches at that shape (`library_ms` null where
    a launched shape has no one PyTorch call computing the same function)."""
    meta = {
        "flash_attention": ("cuda", "lanpaint_tpu_torch/csrc/attention.cu",
                            "lanpaint_tpu/models/layers.py:238; lanpaint_tpu/models/layers.py:131"),
        "wide_attention": ("cuda", "lanpaint_tpu_torch/csrc/wide_attention.cu",
                           "lanpaint_tpu/models/layers.py:131 (_splash_kernel) via "
                           "lanpaint_tpu/models/vae.py:81 and "
                           "lanpaint_tpu/models/video_vae.py:159"),
        "row_norm": ("cuda", "lanpaint_tpu_torch/csrc/row_norm.cu",
                     "lanpaint_tpu/ops/norms.py:93"),
        "fused_half_step": ("cuda", "lanpaint_tpu_torch/csrc/fused.cu",
                            "lanpaint_tpu/ops/fused.py:239"),
        "fused_finish": ("cuda", "lanpaint_tpu_torch/csrc/fused.cu",
                         "lanpaint_tpu/ops/fused.py:259"),
    }

    def run_launches(r):  # this shape's launches in the timed runs
        return (sum(n * FORWARDS[p] for p, n in r["calls"].items())
                + sum(r["run_calls"].values()))

    out = []
    launches = {p: telemetry.families(c) for p, c in launches.items()}
    for name, (route, source, replaces) in meta.items():
        weighted = [(r, run_launches(r)) for r in rows[name]]
        used = [(r, n) for r, n in weighted if n]
        by_ops = sum(r["bound_ms"] * n for r, n in used if r["bound_by"] == "operations")
        total_bound = sum(r["bound_ms"] * n for r, n in used)
        out.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": max(r["err"] for r, _ in weighted),
            "ms": sum(r["ms"] * n for r, n in used),
            "plain_ms": sum(r["plain_ms"] * n for r, n in used),
            "bound_ms": total_bound,
            "bound_by": "operations" if by_ops >= total_bound / 2 else "bytes",
            "library_ms": (sum(r["library_ms"] * n for r, n in used)
                           if all(r["library_ms"] is not None for r, _ in used) else None),
            "per_shape": [{"shape": list(r["shape"]), "kv_len": r.get("kv_len"),
                           "mode": r.get("mode"),
                           "launches_per_forward": r["calls"], "launches_per_run": r["run_calls"],
                           "ms": r["ms"], "plain_ms": r["plain_ms"], "device_us": r["us"],
                           "plain_device_us": r["plain_us"], "bound_us": 1e3 * r["bound_ms"],
                           "bound_by": r["bound_by"], "library": r["library"],
                           "library_ms": r["library_ms"], "library_device_us": r["library_us"],
                           "max_abs_err": r["err"]}
                          for r, _ in weighted],
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_info(smi)
    phase_build()
    qwen_tok = synthetic_qwen_tokenizer()
    z_txt, q_txt = text_lengths(qwen_tok)
    add_new_path_shapes(z_txt, q_txt)
    llama_tok = synthetic_llama_tokenizer()
    n_ll, n_hy = a14_text_lengths(llama_tok)
    add_a14_shapes(n_ll, n_hy)
    rows = phase_kernels()
    phase_small_unet()
    phase_small_controlnet()
    phase_small_dit()
    phase_small_zimage()
    phase_small_a14()
    launches = {}
    launches["sdxl"], den = phase_sdxl(smi)
    launches["tp"] = phase_tp_sdxl(smi, den)
    single = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 12's file, kept for phase 21
    try:
        pipe, sdxl_vae, conds = phase_single_file(smi, den, single)
        launches["pixel"], reference = phase_pixel(smi, den, sdxl_vae, conds)
        launches["pipeline"] = phase_pipeline_run(smi, pipe, reference)
        del sdxl_vae, conds, reference
        launches["controlnet"] = phase_controlnet(smi, den)
        del den
        gc.collect()
        torch.cuda.empty_cache()
        launches["serve"] = phase_serve(smi, single, pipe)
        del pipe
    finally:
        shutil.rmtree(single, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    launches["sd15"] = phase_sd15(smi)
    gc.collect()
    torch.cuda.empty_cache()  # SDXL's and SD1.5's weights go before Flux's 23.8 GB arrive
    launches["flux"] = phase_flux(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_flux_vae(smi)
    launches["flux2"] = phase_flux2(smi)
    gc.collect()
    torch.cuda.empty_cache()  # FLUX.2's 64.4 GB go before the video path
    launches["video"] = phase_video(smi)
    gc.collect()
    torch.cuda.empty_cache()  # TI2V-5B's weights go before the pair's 57 GB arrive
    launches["pair"] = phase_pair(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_t5(smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches["zimage"] = phase_zimage(smi, qwen_tok, z_txt)
    gc.collect()
    torch.cuda.empty_cache()
    phase_qwen_components(smi, qwen_tok, q_txt)
    launches["qwen_edit"] = phase_qwen_edit(smi, qwen_tok, q_txt)
    gc.collect()
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        clip_files = _synthetic_clip_files(directory)
        launches["sd35"] = phase_sd35(smi, clip_files)
        gc.collect()
        torch.cuda.empty_cache()
        launches["hidream"] = phase_hidream(smi, clip_files, llama_tok, n_ll)
        launches["hyvideo"] = phase_hyvideo(smi, clip_files, llama_tok, n_hy)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    launches["parallel"] = phase_parallel(smi)
    phase_tp_plan(smi)
    launches["examples"], example_rows = phase_examples(smi)
    for name, extra in example_rows.items():
        rows[name] = rows[name] + extra
    print(smi)
    print(json.dumps({"kernels": kernels_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
