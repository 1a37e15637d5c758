"""The plain reference the benchmark holds the port to.

Plain PyTorch, float32 throughout (TF32 off while it runs), with none of the
port's kernels, caches or batching: each module here is a frozen copy of
the matching part of `lanpaint_tpu_torch`, with its attention and row-norm
kernels replaced by the plain operations they compute.  Nothing here imports
the port, JAX or the JAX package, and nothing takes a weight, table or draw
that the port made: the benchmark draws the weights and inputs from the
seed and hands the same to both sides.

`nn.precision("fp8")` computes every matrix product and convolution with
both operands rounded to float8 e4m3 under a per-tensor scale: the control,
the step below the bfloat16 that the configurations serve in.
"""
