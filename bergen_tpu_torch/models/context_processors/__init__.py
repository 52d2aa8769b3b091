"""Context processors: RECOMP (extractive and abstractive), DSLR, Provence
and the LLMLingua wrappers."""
