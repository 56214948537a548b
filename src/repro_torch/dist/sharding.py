"""Which mesh axes the batch and the gradient reduction span.

The reference's ``repro/dist/sharding.py`` also carries the partition rules
of the parameters, inputs and caches over the ``model`` axis; the port has
no ``model`` axis yet (tensor parallelism is ROADMAP slice 5), so only the
batch rule is here.
"""

from __future__ import annotations

from typing import Tuple


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch (and gradient reduction) spans."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
