"""Measurement tools of the port, run as ``python -m samcarriestheburden_torch.tools.<name>``."""
