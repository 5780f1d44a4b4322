"""PyTorch/CUDA port of pvpuformer_tpu (interactive segmentation, VPU model).

Mirrors the JAX package's layout and module names. The JAX package is the
numerical reference; this package imports neither JAX nor `pvpuformer_tpu`.
Hand-written Hopper kernels (csrc/) are built on first use on a CUDA tensor;
importing this package needs neither `nvcc` nor a GPU.
"""
