"""Synthetic data series (numpy)."""
