"""Hand-written Hopper kernels (``../csrc/*.cu``) with their plain
PyTorch versions (``ref.py``) and public wrappers (``ops.py``)."""
