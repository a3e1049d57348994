"""Shim for the reference's ``utils.dice_coefficient``."""
from samcarriestheburden_torch.ops.dice import multiclass_dice, multilabel_dice  # noqa: F401
