"""Diffusion backbones of the LanPaint port."""
