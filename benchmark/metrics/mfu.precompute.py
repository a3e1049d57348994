"""The whole encode's share of the card's peak, in %: the least time the
traced window's encoded images take at the dense peaks of their operand
types (``harness/flops.py:encoder_work``), over the window's time."""

from harness import flops


def read(run):
    t, traffic, c = run["trace"], run["traffic"], run["config"]
    images = run["window"].counts["encode_calls"] * traffic["batch_size"]
    least = images * flops.least_seconds(flops.encoder_work(c, traffic["quantize"] == "int8"))
    return 100.0 * least / t.window_s
