"""``reduce_ms``: device milliseconds an update in the reduction and the
int8 wire: ``pack_leaves`` through ``unpack_reduced`` in the step,
``flat_compress_roundtrip`` in MLfabric-A (``portbench.reduce``)."""


def read(ctx):
    s = ctx.trace.range_device_s("portbench.reduce")
    return None if s is None or not ctx.computed else 1e3 * s / ctx.computed
