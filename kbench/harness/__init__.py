"""The general parts of the benchmark: layout, drivers, tracing, peaks."""
