"""Ported readouts."""
