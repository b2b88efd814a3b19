"""Step builders of the port (the serving half so far)."""
