"""The whole refinement's share of the card's peak, in %: the least time of
the traced window's batches (the U-Net forward and the two-round decode of
every class, ``harness/flops.py``) at 989 TFLOP/s, over the window's time."""

from harness import flops


def read(run):
    t, traffic, c = run["trace"], run["traffic"], run["config"]
    b = traffic["batch_size"]
    n_cls = c["unet"]["n_classes"]
    per_batch = (b * flops.unet_work(c["unet"], c["unet"]["grid_hw"])["forward"]
                 + flops.decode_work(c, b * n_cls, b, 2, n_cls + 1))
    least = run["window"].counts["enhance_calls"] * per_batch / flops.PEAK_FLOAT
    return 100.0 * least / t.window_s
