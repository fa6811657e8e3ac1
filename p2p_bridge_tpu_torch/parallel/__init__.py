"""The training step of the port (one device)."""
