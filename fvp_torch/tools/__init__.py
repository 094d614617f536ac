"""Measurement scripts of the port, run on the card from the repo root."""
