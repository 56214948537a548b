"""``model_idle_ms``: milliseconds an update in which the device runs
nothing while the program is inside the model's forward and backward
(``mlfabric.fwd_bwd`` and the spans beneath it: ``forward``, ``backward``,
``attention``, ``moe``), by ``portbench/spans.py``'s rule."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "model", ctx.computed)
