"""Configuration dataclasses the port needs (copies of the reference's)."""
