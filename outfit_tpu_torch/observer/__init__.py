"""Observer geometry and the per-dataset observer cache."""
