"""Dataset processors ported so far (the UT1 fixture)."""
