"""The data pipeline of the port: numpy copies of the JAX package's PUNet
dataset, ScanNet++ and ARKitScenes batch datasets, transforms, loaders and
batch adapter, and of its offline tools (paired-batch preprocessing, RGB-D
fusion, image-feature lifting)."""
