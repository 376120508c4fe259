"""The benchmark's harness: it reads BENCHMARK.json, builds the cell's
system under test from the configuration and mix files, times it, reads
the per-layer metrics from the trace and decides `correct` against the
plain reference (bench_port/reference)."""
