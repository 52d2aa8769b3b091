"""query_generators ported so far."""
