"""A frozen copy of the port's plain paths: the filter, the images-in frame and the
live driver as plain PyTorch, with both kernels replaced by their plain versions and
the C++ feature store by the Python one.  It imports nothing of the port."""
