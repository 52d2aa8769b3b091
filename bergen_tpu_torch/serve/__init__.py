"""Continuous-batching serving (the PyTorch port's counterpart of
``bergen_tpu/serve``): the uniform slot-pool server with its epoch drain,
and the paged-KV server."""

from bergen_tpu_torch.serve.engine import GenerationServer  # noqa: F401
from bergen_tpu_torch.serve.paged import PagedGenerationServer  # noqa: F401
