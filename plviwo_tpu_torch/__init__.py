"""plviwo_tpu_torch — the PyTorch/CUDA port of plviwo_tpu for NVIDIA Hopper.

The JAX package `plviwo_tpu` is the reference; this package mirrors its
module paths (`plviwo_tpu/core/ekf.py` <-> `plviwo_tpu_torch/core/ekf.py`)
and is tested against it on the same numpy inputs.

Differences by design:
  - every tensor of the filter step is batch-first (a leading sequence axis
    B replaces the JAX `vmap`), because hand kernels have no vmap rule;
  - state and covariance are torch.float64, the per-feature camera tensors
    float32 (the `cam_dtype=f32` of the JAX bench);
  - the two Pallas kernels are hand-written CUDA kernels for sm_90a: the
    MSCKF gate/Gram kernel (`csrc/msckf_gram_gate.cu`) and the pyramidal
    LK kernel (`csrc/lk_pyramid.cu`), built with nvcc at first use
    (`ops/cuda_lib.py`); CPU tensors take their plain PyTorch versions;
  - no host syncs inside the step: metrics stay tensors.

The package imports torch, numpy and scipy, never jax and nothing of the
JAX package: it keeps its own copies of the jax-free modules it needs
(`core/layout.py`, `ops/chi2.py`, `core/dynamic_cloning.py`).  Entry points put their tensors on the
card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
