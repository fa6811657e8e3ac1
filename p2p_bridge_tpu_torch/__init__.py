"""p2p_bridge_tpu_torch: the PyTorch + CUDA port of p2p_bridge_tpu.

The JAX package beside it is the reference. This package imports torch
and never jax; framework-free code (schedules, transforms, point-cloud
I/O, the checkpoint key map) is imported from ``p2p_bridge_tpu``.

Layout:
  ops/      point ops; FPS, ball query + group, voxelize and the voxel
            conv + GroupNorm launch hand-written CUDA kernels (csrc/) on
            CUDA tensors and run their plain PyTorch versions on the CPU
  models/   PVCNN2 backbone and the bridge sampler
  weights   JAX param trees and reference torch state_dicts -> the port
  inference patch-based object denoising
"""
