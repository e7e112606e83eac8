"""Ported cores."""
