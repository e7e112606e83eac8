"""Compute primitives and kernel wrappers of the port."""
