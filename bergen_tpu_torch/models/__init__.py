"""Models: tokenizer and checkpoint IO, encoder and decoder forwards,
retrievers and generators."""
