"""``fwd_bwd_ms``: device milliseconds an update in the model's forward
and backward (operations launched inside ``portbench.fwd_bwd``, the range
around ``value_and_grad``)."""


def read(ctx):
    s = ctx.trace.range_device_s("portbench.fwd_bwd")
    return None if s is None or not ctx.computed else 1e3 * s / ctx.computed
