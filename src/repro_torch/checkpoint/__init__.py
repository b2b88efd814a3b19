"""Checkpoints of the port (``checkpoint.checkpoint``)."""
