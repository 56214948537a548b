"""``update_ms``: device milliseconds an applied update in the in-place
eq.-2 update (``momentum_sgd_update_`` in the step, the server's ``push``
in MLfabric-A: ``portbench.update``)."""


def read(ctx):
    s = ctx.trace.range_device_s("portbench.update")
    return None if s is None or not ctx.updates else 1e3 * s / ctx.updates
