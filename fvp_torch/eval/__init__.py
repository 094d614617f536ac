"""Evaluation protocols of the port (numpy)."""
