"""State initialization on the host (numpy copies of plviwo_tpu/init): the static
IMU initializer and the IMU+wheel initializer."""
