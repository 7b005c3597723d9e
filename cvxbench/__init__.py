"""The port's benchmark: harness, reference, configurations, traffic, metrics."""
