"""Tensor operations of the SAM path."""
