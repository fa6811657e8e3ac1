"""p2p_bridge_tpu_torch: the PyTorch + CUDA port of p2p_bridge_tpu.

The JAX package beside it is the reference. This package imports torch
and nothing of jax or of ``p2p_bridge_tpu``: the framework-free code it
needs (schedules, point-cloud I/O, the object normalisation, the
checkpoint key map, the YAML reader, the PUNet data pipeline, the
training CLI's arguments, the room runtime with its C++ source) is copied
here, and tests hold each copy against its original.

Layout:
  ops/      point ops; FPS, ball query + group, voxelize (and its
            backward), the voxel conv + GroupNorm, trilinear devoxelize
            and 3-NN interpolation launch hand-written CUDA kernels
            (csrc/) on CUDA tensors and run their plain PyTorch versions
            on the CPU, in f32 or bf16; each is differentiable
  metrics/  the auction EMD (a CUDA kernel) and the training alignment;
            Chamfer, point-to-mesh and the room evaluation's facade
  models/   PVCNN2 backbone (compute dtype from the config), the bridge
            sampler and loss, the losses, checkpoints and the CLIs' loaders
  parallel/ the training step: alignment, gradients, clip, AdamW, EMA
  data/     the PUNet training data pipeline
  runtime/  the native host runtime of the room path (g++, ctypes)
  utils/    point-cloud file I/O, the CLI's YAML reader and arguments, EMA
  weights   JAX param trees and reference torch state_dicts -> the port
  inference patch-based object denoising
  rooms     room-scale patch denoising
  train     the training loop and its CLI
  denoise_object, denoise_room, evaluate_rooms: the CLIs
"""
