"""The benchmark's harness: cells by name, the RTM loop, the trace, the check."""
