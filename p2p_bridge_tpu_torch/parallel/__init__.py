"""The training step of the port and its data mesh over torch.distributed."""
