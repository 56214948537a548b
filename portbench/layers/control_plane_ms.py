"""``control_plane_ms``: host milliseconds a commit that MLfabric-A's
``run`` spends outside its ``_on_compute`` and ``_on_commit`` callbacks:
the simulated control plane (``core/simulator.py:ClusterSim``) and the
trainer's own bookkeeping."""


def read(ctx):
    s = ctx.host.get("control_plane_s")
    return None if s is None or not ctx.updates else 1e3 * s / ctx.updates
