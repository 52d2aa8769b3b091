"""rerankers ported so far."""
