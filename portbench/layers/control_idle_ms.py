"""``control_idle_ms``: milliseconds a commit in which the device runs
nothing while MLfabric-A's control plane works: under ``mlfabric.plan``
(the scheduler) and ``mlfabric.data``, or under ``run``, ``compute`` or
``commit`` with no child open, by ``portbench/spans.py``'s rule."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "control", ctx.updates)
