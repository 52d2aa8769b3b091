"""LoRA adapters for the llama family (the PyTorch port's counterpart of
``bergen_tpu/train/lora.py``).

Adapters are extra ``lora_a`` [in, r], ``lora_b`` [r, out] and
``lora_scale`` leaves inside each linear's dict ("all-linear", the output
head excluded, as peft's); ``llama._proj`` adds ``x @ A @ B * scale``
(``llama._lora_dense``), the optimizer trains the adapter leaves only and
``merge`` folds them into the kernels for inference.  ``lora_dropout`` is
ignored, as in JAX.  A is drawn N(0, 1/r) from a seeded ``torch.Generator``
(the JAX package's ``jax.random`` draws cannot be reproduced without JAX;
the distributions are the same), B is zero, so training starts at the base
model.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from bergen_tpu_torch.models import convert

ADAPTER_KEYS = ("lora_a", "lora_b")


def _is_linear(d) -> bool:
    return isinstance(d, dict) and "kernel" in d


def _walk(node, path=""):
    """(dotted path, linear dict) of every linear below ``node``, in the
    tree's order."""
    if _is_linear(node):
        yield path, node
        return
    items = node.items() if isinstance(node, dict) else (
        enumerate(node) if isinstance(node, list) else ())
    for k, v in items:
        yield from _walk(v, f"{path}.{k}" if path else str(k))


def init_lora(params: Dict[str, Any], rank: int, alpha: float,
              generator: torch.Generator | None = None,
              dtype=torch.float32) -> Dict[str, Any]:
    """Attach adapters to every linear but ``lm_head``, in place: A ~
    N(0, 1/rank) drawn on the host from ``generator`` (so the card and the
    CPU draw the same values), B = 0, scale alpha / rank, all in ``dtype``
    (f32, as JAX keeps them over bf16 weights).  A mixture-of-experts
    tree is refused: its experts are [E, d_in, d_out] stacks, on which
    JAX's ``init_lora`` fails (ROADMAP.md, faults of the reference)."""
    if any("moe" in layer for layer in params["layers"]):
        raise NotImplementedError(
            "LoRA on a mixture-of-experts generator: adapters on the stacked "
            "[E, d_in, d_out] experts are not defined (JAX's init_lora "
            "fails on them); train it with train=full")
    for path, node in _walk(params):
        if path.split(".")[0] == "lm_head":
            continue  # peft's 'all-linear' excludes the output head
        if "tp_shape" in node:
            raise NotImplementedError(
                f"LoRA on {path}, a tensor-parallel slice (ROADMAP.md Queue "
                "1 #10, multi-GPU)")
        d_in, d_out = node["kernel"].shape
        dev = node["kernel"].device
        a = torch.randn(d_in, rank, generator=generator, dtype=dtype)
        node["lora_a"] = (a / math.sqrt(rank)).to(dev)
        node["lora_b"] = torch.zeros(rank, d_out, dtype=dtype, device=dev)
        node["lora_scale"] = torch.tensor(alpha / rank, dtype=dtype,
                                          device=dev)
    return params


def lora_mask(params) -> Dict[str, bool]:
    """{dotted path: trainable} over every tensor leaf: True only on the
    adapter leaves (JAX's boolean pytree for ``multi_transform``)."""
    return {p: p.rsplit(".", 1)[-1] in ADAPTER_KEYS
            for p in convert.flatten_paths(params)}


def merge(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold W <- W + A @ B * scale (in f32, rounded once to W's dtype) and
    drop the adapter leaves, in place."""
    for _, node in _walk(params):
        if "lora_a" not in node:
            continue
        with torch.no_grad():
            delta = (node["lora_a"] @ node["lora_b"]) * node["lora_scale"]
            w = node["kernel"]
            node["kernel"] = (w.float() + delta.float()).to(w.dtype)
        for k in ("lora_a", "lora_b", "lora_scale"):
            node.pop(k)
    return params


def extract_adapters(params) -> Dict[str, np.ndarray]:
    """{dotted path + '.lora_a' | '.lora_b': array}: JAX's checkpoint
    names and shapes."""
    out = {}
    for path, node in _walk(params):
        if "lora_a" in node:
            for k in ADAPTER_KEYS:
                out[f"{path}.{k}"] = node[k].detach().float().cpu() \
                    .numpy().copy()  # a copy: training updates in place
    return out


def load_adapters(params, flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``extract_adapters`` onto an adapter-carrying tree:
    ``convert.load_flat`` over the adapter leaves."""
    return convert.load_flat(params, flat, select=lambda p: p.rsplit(
        ".", 1)[-1] in ADAPTER_KEYS)
