"""CLI entry point of the PyTorch port (the counterpart of ``bergen.py``):

    python -m bergen_tpu_torch dataset=ut1 retriever=bge-base-en-v1.5 \\
        generator=tinyllama-chat [device=cpu]

The root config is picked by the ``CONFIG`` env var (default ``rag``) and
composed from the repository's ``config/`` tree with the same hydra-style
overrides as ``bergen.py``: with a ``train`` config it runs the train
stage (``RAG.train``), else the dev eval.  ``device=cpu|cuda`` (default
cuda) is read by the CLI itself and kept out of the config, so an
experiment is named the same as the JAX package's run of the same config.

A generator with ``tp`` > 1 runs under ``torchrun``, one process a card:

    torchrun --nproc-per-node 2 -m bergen_tpu_torch dataset=ut1 \\
        generator=llama-2-13b-chat

``dist_backend=gloo device=cuda:0`` (also kept out of the config) puts
every rank on one card, which NCCL refuses; ``device=cpu`` takes gloo.
A ``train=`` config trains the tp generator there too (every rank its
slice, rank 0 writing), and a query generator that rewrites with the
generator runs on its ranks.
"""

from __future__ import annotations

import os
import sys


def main(config, device: str | None = None,
         dist_backend: str | None = None):
    from bergen_tpu_torch.parallel import mesh
    from bergen_tpu_torch.rag import RAG

    if mesh.world_size() > 1:
        # under torchrun: this rank's device (cuda:LOCAL_RANK, or the one
        # card every rank shares over gloo)
        device = mesh.init(device, dist_backend).device
    rag = RAG(**config, config=config, device=device)
    if config.get("train") is not None:
        rag.train()
    else:
        rag.eval(dataset_split="dev")


def cli(argv: list[str]) -> None:
    from bergen_tpu_torch import confy

    device = dist_backend = None
    overrides = []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.split("=", 1)[1]
        elif arg.startswith("dist_backend="):
            dist_backend = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    config_name = os.environ.get("CONFIG", "rag")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = confy.compose(os.path.join(repo, "config"), config_name, overrides)
    main(cfg, device=device, dist_backend=dist_backend)


if __name__ == "__main__":
    cli(sys.argv[1:])
