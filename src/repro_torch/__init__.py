"""``repro_torch`` — the PyTorch and CUDA port of the MLfabric reproduction.

A second package beside the JAX reference ``repro``, with the same
sub-package layout so each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and nothing of ``repro``: the
framework-free modules it needs (the control plane in ``core``, the
telemetry in ``obs``, ``configs``, ``data``) are copies.  Entry points run
on the card unless the caller passes ``device="cpu"``.

What is ported so far is the MLfabric-A main path: ``ps.AsyncTrainer``
training the dense decoder of ``models`` with ``compress=True``, its
updates crossing the wire through the CUDA kernels in ``kernels``.
"""
