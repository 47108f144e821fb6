"""Deterministic synthetic data (the port of `repro.data`)."""
