"""Wan2.2 81-frame-scale video inpainting over a mesh of processes: ring
attention on the frame axis and Megatron tensor parallelism of the DiT
(reference README.md:240-260 runs 81 frames on one 96 GB GPU in ~14-16
min; the mesh spreads both compute and weights over the cards).

On N cards of one host (NCCL), or N CPU processes (gloo):
    torchrun --nproc-per-node N -m lanpaint_tpu_torch.examples.wan22_seq_parallel \
        --smoke --frames 8 [--tensor 2] [--device cpu]
Alone it runs as a world of one."""

import numpy as np
import torch
import torch.distributed as dist

from lanpaint_tpu_torch import LanPaintConfig, LanPaintSampler
from lanpaint_tpu_torch.examples.common import example_argparser, example_device, report
from lanpaint_tpu_torch.models.load import import_wan, load_safetensors
from lanpaint_tpu_torch.models.wan import TINY_WAN_CONFIG, WAN22_T2V_14B_CONFIG
from lanpaint_tpu_torch.models.zoo import build_tiny_wan, build_wan_seq_parallel
from lanpaint_tpu_torch.parallel import MeshSpec, init_world, make_mesh
from lanpaint_tpu_torch.parallel.mesh import mesh_device, world_size
from lanpaint_tpu_torch.sigmas import calculate_sigmas


def run(args, device):
    n = world_size()
    seq = args.seq or (n // args.tensor)
    mesh = make_mesh(MeshSpec(data=n // (seq * args.tensor), seq=seq, tensor=args.tensor),
                     device.type)
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {n} processes")

    if args.checkpoint:
        cfgm = WAN22_T2V_14B_CONFIG
        state = import_wan(load_safetensors(args.checkpoint), cfgm)
        c, hw, ctx_d = 16, 60, 4096
    else:
        cfgm = TINY_WAN_CONFIG
        _, module = build_tiny_wan(seed=0, device=device)
        state = module.state_dict()
        c, hw, ctx_d = cfgm.in_channels, 16, cfgm.context_dim

    model, _ = build_wan_seq_parallel(cfgm, state, mesh,
                                      tp_axis="tensor" if args.tensor > 1 else None)
    device = mesh_device(mesh)
    b, f = 1, args.frames
    latent = torch.zeros((b, c, f, hw, hw), device=device)
    mask = np.zeros((b, c, f, hw, hw), np.float32)
    mask[:, :, f // 2:] = 1.0  # repaint the second half of the frames
    cond = {"context": torch.zeros((b, 8, ctx_d), device=device)}
    sigmas = calculate_sigmas(model.sigma_table, "simple", args.steps)

    sam = LanPaintSampler(model, config=LanPaintConfig(n_steps=2), sampler_name="euler", cfg=1.0)
    out, _ = sam(latent=latent, sigmas=sigmas, cond=cond, mask=torch.from_numpy(mask),
                 seed=args.seed)
    if rank0:
        report("wan22_seq_parallel", out)


def main():
    p = example_argparser("Wan2.2 sequence-parallel video inpainting")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--seq", type=int, default=0,
                   help="seq-axis size (default: all processes)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-parallel axis size (weights sharded)")
    args = p.parse_args()
    device = example_device(args)
    with init_world(device.type):
        run(args, device)


if __name__ == "__main__":
    main()
