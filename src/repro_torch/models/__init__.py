"""Models the port's data paths feed (the DLRM of paper §8 so far)."""
