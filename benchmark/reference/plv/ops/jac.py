"""Forward-mode Jacobians of batched functions.

The JAX package takes per-sample Jacobians with `vmap(jacfwd(f))`.  Here f
is written for arbitrary leading batch dims, so the Jacobian is ONE
`torch.func.jvp` of f on inputs given an extra axis of K = (number of input
coordinates) directions, with the identity as tangents: a handful of large
tensor ops instead of K passes of small ones (the step is launch-bound).
This also sidesteps `vmap(jacfwd)` over per-sample functions, whose 0-dim
intermediates make torch 2.x promote float32 tangents to float64.
"""

from __future__ import annotations

import torch
from torch.func import jvp


def jacfwd_batched(fn, args, argnums):
    """Jacobians of fn(*args) (...,m) wrt args[a] (...,n_a) for a in argnums.

    All args are floating tensors whose leading dims broadcast to the
    output's batch shape.  Returns a tuple of (...,m,n_a) tensors."""
    args = tuple(args)
    sizes = [args[a].shape[-1] for a in argnums]
    K = sum(sizes)
    batch = torch.broadcast_shapes(*(x.shape[:-1] for x in args))
    # one direction per input coordinate, on a new axis before the last
    ex = [x[..., None, :].expand(batch + (K, x.shape[-1])) for x in args]
    eye = torch.eye(K, dtype=args[argnums[0]].dtype, device=args[argnums[0]].device)
    tangents, off = [], 0
    for n in sizes:
        tangents.append(eye[:, off:off + n].expand(batch + (K, n)).contiguous())
        off += n

    def f(*xs):
        full = list(ex)
        for a, x in zip(argnums, xs):
            full[a] = x
        return fn(*full)

    _, t = jvp(f, tuple(ex[a].contiguous() for a in argnums), tuple(tangents))
    return tuple(torch.split(t.transpose(-1, -2), sizes, dim=-1))
