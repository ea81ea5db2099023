"""Batched work over independent pairs (counterpart of slam3d_gx_tpu/parallel)."""
