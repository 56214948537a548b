"""Hand-written Hopper kernels of the port, with their plain versions.

``ops`` holds the wrappers the rest of the port calls; ``build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""

from .ops import dequant_aggregate_op, grad_aggregate_op, quantize_op

__all__ = ["dequant_aggregate_op", "grad_aggregate_op", "quantize_op"]
