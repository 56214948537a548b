"""Hand-written Hopper kernels of the port, with their plain versions.

``ops`` holds the wrappers the rest of the port calls; ``build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""

from .ops import (compress_update, dequant_aggregate_op, dequantize_op,
                  flash_attention_op, grad_aggregate_op, quantize_op,
                  scatter_aggregate_op, switch_sum_op)

__all__ = ["compress_update", "dequant_aggregate_op", "dequantize_op",
           "flash_attention_op", "grad_aggregate_op", "quantize_op",
           "scatter_aggregate_op", "switch_sum_op"]
