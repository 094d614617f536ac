"""Datasets and the host batch pipeline of the port (numpy)."""
