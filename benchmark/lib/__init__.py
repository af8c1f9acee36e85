"""The harness: cells, device checks, seeded inputs, tracing, comparison."""
