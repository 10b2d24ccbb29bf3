"""Trajectory evaluation of the port: alignment and ATE (numpy)."""
