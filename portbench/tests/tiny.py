"""Tiny sizes of each configuration for the CPU tests: every width and
count cut, the structure kept."""

SIZES = {
    "sdxl-1024": {
        "name": "sdxl-1024", "family": "unet", "in_channels": 4, "out_channels": 4,
        "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
        "transformer_depth": [1, 1], "transformer_depth_middle": 1, "context_dim": 512,
        "head_dim": 16, "num_heads": 8, "adm_in_channels": 48, "dtype": "bfloat16",
        "latent_shape": [4, 16, 16], "image_size": [128, 128], "context_tokens": 16},
    "flux-dev-1024": {
        "name": "flux-dev-1024", "family": "mmdit", "in_channels": 16, "out_channels": 16,
        "hidden": 64, "num_heads": 4, "mlp_ratio": 4.0, "depth_double": 2, "depth_single": 2,
        "context_dim": 32, "vec_dim": 16, "guidance_embed": True, "axes_dim": [4, 6, 6],
        "theta": 10000.0, "patch": 2, "latent_channels": 4, "shift": 1.15, "guidance": 3.5,
        "dtype": "bfloat16", "latent_shape": [4, 16, 16], "image_size": [128, 128],
        "context_tokens": 8},
}
CELLS = {"sdxl-1024": "sdxl-1024.single", "flux-dev-1024": "flux-dev-1024.single"}


def traffic(cell: str, **changes) -> dict:
    """The cell's traffic file, shortened to 4 steps, 2 think."""
    from portbench.harness import files

    t = files.traffic(cell)
    t = dict(t, steps=4, think=2, warmup_steps=2, check_middle_steps=1,
             step_err_from=min(t["step_err_from"], 1), profile_forwards=[2, 3])
    t.update(changes)
    return t
