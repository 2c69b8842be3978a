"""Synthetic SL distributions and batch formation (numpy)."""
