"""Pipeline stages: query generation and retrieval."""
