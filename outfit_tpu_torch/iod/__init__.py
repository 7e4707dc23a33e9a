"""IOD parameters and the seed-orbit result type."""
