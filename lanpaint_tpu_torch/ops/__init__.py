"""Kernels and numerics of the LanPaint port."""
