"""Observation ingestion (MPC 80-column), the observatory catalog and error models."""
