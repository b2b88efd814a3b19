"""The train step and loop of the port, and its serving steps."""
