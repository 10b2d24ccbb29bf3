"""plviwo_tpu_torch — the PyTorch/CUDA port of plviwo_tpu for NVIDIA Hopper.

The JAX package `plviwo_tpu` is the reference; this package mirrors its
module paths (`plviwo_tpu/core/ekf.py` <-> `plviwo_tpu_torch/core/ekf.py`)
and is tested against it on the same numpy inputs.

Differences by design:
  - every tensor of the filter step is batch-first (a leading sequence axis
    B replaces the JAX `vmap`), because hand kernels have no vmap rule;
  - state and covariance are torch.float64, the per-feature camera tensors
    float32 (the `cam_dtype=f32` of the JAX bench);
  - the Pallas MSCKF gate/Gram kernel is a hand-written CUDA kernel
    (`csrc/msckf_gram_gate.cu`), built with nvcc at first use; CPU tensors
    take its plain PyTorch version;
  - no host syncs inside the step: metrics stay tensors.

The package imports torch and never jax.  From the JAX package it imports
only `plviwo_tpu.core.layout` and `plviwo_tpu.ops.chi2`, both jax-free.
"""

__version__ = "0.1.0"
