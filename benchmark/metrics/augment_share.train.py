"""The augmentation's share of the card's busy time in training, in %: the
device time charged to the program's ``trainer.augment`` spans (the
normalisation and the affine warp; ``harness/program_trace.py``) over the
traced window's busy time."""

from harness.program_trace import device_share


def read(run):
    return device_share(run, "trainer.augment")
