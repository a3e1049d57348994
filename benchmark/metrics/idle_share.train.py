"""The device's idle share of the traced window, in %: one minus the union
of its kernel, copy and set intervals over the window's wall time."""


def read(run):
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
