"""Checkpoint integrity sidecars of the port."""
