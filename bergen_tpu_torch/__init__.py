"""bergen_tpu_torch — the PyTorch/CUDA port of bergen_tpu.

A second package beside ``bergen_tpu`` (the JAX reference), ported slice by
slice (``ROADMAP.md`` says what is ported), with the same staged RAG run,
config tree, CLI overrides and on-disk artifacts.  Plain tensor code is
PyTorch; every TPU kernel on the ported path is a kernel written by hand for
Hopper (``csrc/``), built with nvcc at first CUDA use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
