"""Option tree of the port (the JAX package's dataclasses, copied)."""
