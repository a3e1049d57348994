"""The component selection's share of the card's busy time in the refine,
in %: the device time charged to the program's ``enhance.select`` spans
(K8, the components' counts, the keep mask; ``harness/program_trace.py``)
over the traced window's busy time."""

from harness.program_trace import device_share


def read(run):
    return device_share(run, "enhance.select")
