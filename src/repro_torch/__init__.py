"""RoCE BALBOA in PyTorch for an NVIDIA H100.

The same system as the JAX package ``repro`` (which stays the
reference), module for module: ``core`` holds the transport and the
service chain, ``kernels`` the hand-written Hopper kernels under
``csrc/`` with their plain PyTorch versions, ``data`` the synthetic DPI
data.  The package imports neither ``jax`` nor ``repro``.
"""
