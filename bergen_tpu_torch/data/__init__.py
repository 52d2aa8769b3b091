"""Dataset processing: the column store, processors and their cache."""
