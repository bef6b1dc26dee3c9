"""CPU tests of the benchmark harness."""
