"""Measurement scripts for the port; each runs with ``python -m``."""
