"""Differential orbit correction (weighted least squares), batched."""
