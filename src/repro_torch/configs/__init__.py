"""Named model configurations of the port (``dlrm`` so far)."""
