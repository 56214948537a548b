"""``mfu``: the whole step's share of the chip's bf16 peak, from the model
FLOPs of the tokens the traced window completed (``portbench/flops.py``)."""

from portbench.flops import BF16_FLOPS


def read(ctx):
    if not ctx.tokens or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.flops_per_token * ctx.tokens / ctx.window_s / BF16_FLOPS
