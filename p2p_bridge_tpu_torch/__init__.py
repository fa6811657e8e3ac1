"""p2p_bridge_tpu_torch: the PyTorch + CUDA port of p2p_bridge_tpu.

The JAX package beside it is the reference. This package imports torch
and nothing of jax or of ``p2p_bridge_tpu``: the framework-free code it
needs (schedules, point-cloud I/O, the object normalisation, the
checkpoint key map, the YAML reader) is copied here, and tests hold each
copy against its original.

Layout:
  ops/      point ops; FPS, ball query + group, voxelize, the voxel
            conv + GroupNorm, trilinear devoxelize and 3-NN interpolation
            launch hand-written CUDA kernels (csrc/) on CUDA tensors and
            run their plain PyTorch versions on the CPU, in f32 or bf16
  models/   PVCNN2 backbone (compute dtype from the config) and the
            bridge sampler
  utils/    point-cloud file I/O and the CLI's YAML reader
  weights   JAX param trees and reference torch state_dicts -> the port
  inference patch-based object denoising
"""
