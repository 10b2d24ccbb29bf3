"""Trajectory evaluation of the port (numpy): alignment, ATE/RPE/NEES, file
IO, and the CLI `python -m plviwo_tpu_torch.eval` (ate / rpe / nees /
compare / timing / dataset / timing-compare / flamegraph / percentages /
plot / convert)."""
