"""Shim for the reference's ``utils.seg_refinement``."""
from samcarriestheburden_torch.engine.refinement import (  # noqa: F401
    RndWalkSegRefiner, SamSegRefiner, SegEnhance, SegRefiner)

SAMSegRefiner = SamSegRefiner  # reference spelling
