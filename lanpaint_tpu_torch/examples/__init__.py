"""The example scripts of the port, one for each of `examples/` (the
reference's example workflows as scripts), importing this package only:

    python -m lanpaint_tpu_torch.examples.<name> --smoke [--device cpu]

Without `--checkpoint` each runs in smoke mode: random weights from a seed
at a small latent, the whole path end to end; on the CUDA card unless
`--device` names another device.  `wan22_seq_parallel` runs under
`torchrun --nproc-per-node N` (NCCL on the cards, gloo with `--device cpu`)
or alone as a world of one."""
