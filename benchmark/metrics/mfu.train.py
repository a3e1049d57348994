"""The whole training step's share of the card's peak, in %: the least time
of the traced window's samples (forward and backward of every
convolution, ``harness/flops.py:unet_work``) at 989 TFLOP/s, over the
window's time."""

from harness import flops


def read(run):
    t, c = run["trace"], run["config"]
    samples = run["window"].work
    least = samples * flops.unet_work(c, c["grid_hw"])["train"] / flops.PEAK_FLOAT
    return 100.0 * least / t.window_s
