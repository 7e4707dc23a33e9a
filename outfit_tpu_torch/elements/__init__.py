"""Orbital element sets, two-body propagation with partials, uncertainties."""
