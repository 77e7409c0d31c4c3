"""The cell-independent parts of the benchmark: the manifest, the coders
over the port, the profiled stretch, the metric readers' loader, the
result line and the import guard."""
