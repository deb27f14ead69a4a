"""The harness: cells by name, the runners, the trace and the check."""
