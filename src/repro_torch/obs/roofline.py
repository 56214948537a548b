"""Analytic HBM-traffic model for the aggregator receive path.

Lives in ``repro.obs`` so the profiler (and the BENCH harness) can quote
modeled bytes next to measured wall-clock without depending on the
``benchmarks/`` scripts; ``benchmarks/roofline.py`` re-exports it for the
original import path.
"""

from __future__ import annotations

from typing import Dict


def aggregator_hbm_traffic(n: int, d: int, *, quant_block: int = 256,
                           compressed: bool = True) -> Dict[str, float]:
    """Modeled aggregator-host HBM bytes for ONE inter-pod bucket.

    ``n`` pod updates of ``d`` f32 elements arrive (int8 + per-block f32
    scales when ``compressed``).  The aggregator is purely memory-bound
    (paper §4: it computes the weighted sum of incoming updates), so HBM
    bytes ARE the roofline.

    unfused (kernels/quantize.py then kernels/grad_aggregate.py):
        read the wire payload, WRITE n dequantized f32 copies, READ them
        all back for the aggregate, write the f32 result (norm fused).
    fused (kernels/dequant_aggregate.py):
        read the wire payload + weights, write the f32 result — the
        8*n*d-byte round-trip disappears.
    """
    scales = 4.0 * d / quant_block
    if compressed:
        wire = n * (d + scales)                  # int8 payload + scales
    else:
        wire = 4.0 * n * d                       # f32 on the wire
        # uncompressed has no dequantize stage: both paths degenerate to
        # the already-fused grad_aggregate (read n, write 1)
        bytes_ = wire + 4.0 * n + 4.0 * d
        return {"unfused_bytes": bytes_, "fused_bytes": bytes_,
                "ratio": 1.0}
    unfused = wire + 4.0 * n * d + (4.0 * n * d + 4.0 * n) + 4.0 * d
    fused = wire + 4.0 * n + 4.0 * d
    return {"unfused_bytes": unfused, "fused_bytes": fused,
            "ratio": unfused / fused}
