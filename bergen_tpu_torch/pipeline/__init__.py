"""Pipeline stages: query generation, retrieval, reranking and context
processing."""
