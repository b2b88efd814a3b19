"""Optimizers of the port (``optim.optimizers``)."""
