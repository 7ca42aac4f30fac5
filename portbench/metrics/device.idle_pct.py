"""device.idle_pct (layer: device): the share of the traced window in which
no activity ran on the card, from the profiler's device trace."""


def read(ctx):
    summary = ctx["trace"]
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
