"""Batched serving entry points."""
