"""CLI entry point of the PyTorch port (the counterpart of ``bergen.py``):

    python -m bergen_tpu_torch dataset=ut1 retriever=bge-base-en-v1.5 \\
        generator=tinyllama-chat [device=cpu]

The root config is picked by the ``CONFIG`` env var (default ``rag``) and
composed from the repository's ``config/`` tree with the same hydra-style
overrides as ``bergen.py``: with a ``train`` config it runs the train
stage (``RAG.train``), else the dev eval.  ``device=cpu|cuda`` (default
cuda) is read by the CLI itself and kept out of the config, so an
experiment is named the same as the JAX package's run of the same config.
"""

from __future__ import annotations

import os
import sys


def main(config, device: str | None = None):
    from bergen_tpu_torch.rag import RAG

    rag = RAG(**config, config=config, device=device)
    if config.get("train") is not None:
        rag.train()
    else:
        rag.eval(dataset_split="dev")


def cli(argv: list[str]) -> None:
    from bergen_tpu_torch import confy

    device = None
    overrides = []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    config_name = os.environ.get("CONFIG", "rag")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = confy.compose(os.path.join(repo, "config"), config_name, overrides)
    main(cfg, device=device)


if __name__ == "__main__":
    cli(sys.argv[1:])
