"""The prompt decode's share of the card's busy time in the refine, in %:
the device time charged to the program's ``enhance.decode`` spans (both
rounds; ``harness/program_trace.py``) over the traced window's busy time."""

from harness.program_trace import device_share


def read(run):
    return device_share(run, "enhance.decode")
