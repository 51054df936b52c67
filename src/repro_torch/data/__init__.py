"""Synthetic data (the repository is offline)."""
