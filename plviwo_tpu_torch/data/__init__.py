"""Dataset readers and image files of the port."""
