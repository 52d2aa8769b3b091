"""Query generators: copy, NLLB translation and API-query unfolding."""
