"""generators ported so far."""
