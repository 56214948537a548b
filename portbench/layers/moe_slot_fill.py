"""``moe_slot_fill``: the share of the MoE layers' capacity slots that the
traced window filled: ``moe/kept`` (router claims given a slot) over
``moe/slots`` (groups x experts x capacity), the counters the program adds
to ``repro_torch.obs.RUNTIME`` while the profiler records.  A
rematerialised layer counts again in the backward, which leaves the share
as it is."""


def read(ctx):
    try:
        from repro_torch.obs import RUNTIME
    except ImportError:
        return None
    if "moe/slots" not in RUNTIME or "moe/kept" not in RUNTIME:
        return None
    slots = float(RUNTIME.counter("moe/slots").value)
    kept = float(RUNTIME.counter("moe/kept").value)
    return 100.0 * kept / slots if slots else None
