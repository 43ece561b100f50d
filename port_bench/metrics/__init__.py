"""Per-layer and end-to-end metric readers, one file per metric, found by
the metric's name in BENCHMARK.json."""
