"""Shim for the reference's ``utils.segmentation_preprocessing``."""
from samcarriestheburden_torch.ops.morphology import (  # noqa: F401
    diamond, dilation, disk, erosion, square, star)
from samcarriestheburden_torch.ops.seg_preprocessing import (  # noqa: F401
    erode_mask_with_disc_struct, opening_with_connected_component,
    remove_all_but_one_connected_component)
