"""Per-layer metric readers, one file a metric, each found by its name in
``BENCHMARK.json``.  A reader's ``read(ctx)`` returns the metric's value,
or None where the traced window holds nothing for it to read
(``portbench.harness.LayerContext`` says what ``ctx`` holds)."""
