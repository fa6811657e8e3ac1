"""The training data pipeline of the port: numpy copies of the JAX
package's PUNet dataset, transforms, loaders and batch adapter."""
