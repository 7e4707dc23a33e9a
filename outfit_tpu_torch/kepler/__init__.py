"""Angle helpers."""
