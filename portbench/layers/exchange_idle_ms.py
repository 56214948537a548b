"""``exchange_idle_ms``: milliseconds an update in which the device runs
nothing while the program packs, reduces, sends or applies an update
(``mlfabric.pack``, ``reduce``, ``bucket``, ``unpack``, ``wire``, ``sync``
and ``update``), by ``portbench/spans.py``'s rule."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "exchange", ctx.computed)
