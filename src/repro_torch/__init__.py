"""RoCE BALBOA in PyTorch for an NVIDIA H100.

The same system as the JAX package ``repro`` (which stays the
reference), module for module: ``core`` holds the transport, the
service chain, the §8 ingest and the collectives, ``kernels`` the
hand-written Hopper kernels under ``csrc/`` with their plain PyTorch
versions, ``models`` the DLRM (with ``configs`` and ``common``), ``data``
the synthetic DPI data and DLRM records.  The package imports neither
``jax`` nor ``repro``.
"""
