"""Shim for the reference's ``utils.cvat_parser``."""
from samcarriestheburden_torch.data.cvat import CVATParser, Mask  # noqa: F401
