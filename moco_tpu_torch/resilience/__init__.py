"""Resilience of the port: checkpoint integrity sidecars, the typed errors
and the learning-health sentinel."""
