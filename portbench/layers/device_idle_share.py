"""``device_idle_share``: the share of the traced window that no device
operation covers (the union of their intervals)."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (w - ctx.trace.busy_s()) / w if w > 0 else None
