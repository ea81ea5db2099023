"""CLI entry points with the reference binaries' names and argument shapes;
each module runs as `python -m slam3d_gx_torch.cli.<name>`."""
