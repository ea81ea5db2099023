"""Host-side helpers of the port: headless visualization (viz.py), stage
timing and device traces (profiling.py), NaN/Inf and index checks
(debug.py)."""
