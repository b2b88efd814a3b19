"""Placement of the port's tensors (one card so far)."""
