"""Synthetic sensor simulator (numpy port of plviwo_tpu/sim): chip-smoke and test inputs."""
