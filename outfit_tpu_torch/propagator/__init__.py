"""Propagator configuration."""
