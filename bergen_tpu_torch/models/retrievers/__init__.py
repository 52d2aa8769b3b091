"""retrievers ported so far."""
