"""The plain float32 reference the benchmark holds the program to: PVCNN2,
the bridge sampler, room patching and recomposition. It imports nothing
of the program."""
