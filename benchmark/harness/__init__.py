"""The benchmark's harness: one cell's set-up, window, trace reading and
correctness check, driven by the files that ``BENCHMARK.json`` names."""
