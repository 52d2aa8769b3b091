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

On a tensor-parallel rank's slice (``parallel/shard.py``: a node with a
``tp_shape``) the adapters are placed as JAX's ``_linear_specs`` places
them (``shard.adapter_piece``): each A is drawn whole, in the whole
tree's order, and the rank keeps its slice, so that every tp starts from
tp 1's adapters; ``extract_adapters`` gathers them to whole shapes over
the model axis (a collective: every rank calls it), ``load_adapters``
slices whole ones, and ``merge`` folds each slice's own A @ B into its
slice of the kernel, which is the slice of the whole merge.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from bergen_tpu_torch.models import convert
from bergen_tpu_torch.parallel import mesh as _mesh
from bergen_tpu_torch.parallel import shard as _shard

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
        d_in, d_out = node.get("tp_shape") or node["kernel"].shape
        dev = node["kernel"].device
        a = torch.randn(d_in, rank, generator=generator, dtype=dtype)
        whole = {"lora_a": a / math.sqrt(rank),
                 "lora_b": torch.zeros(rank, d_out, dtype=dtype),
                 "lora_scale": torch.tensor(alpha / rank, dtype=dtype)}
        node.update(_slices(node, whole, dev))
    return params


def _model_rank(tp: int) -> int:
    return _mesh.get_mesh(model=tp).model_rank if tp > 1 else 0


def _slices(node, whole: Dict[str, torch.Tensor], dev) -> Dict[str, Any]:
    """This rank's slices of a node's whole adapter leaves, on ``dev``."""
    dim, tp = _shard.split_of(node)
    r = _model_rank(tp)
    return {k: _shard.adapter_piece(k, v, dim, tp, r).to(dev)
            for k, v in whole.items()}


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


def extract_adapters(params, leaves: Dict[str, torch.Tensor] | None = None
                     ) -> Dict[str, np.ndarray]:
    """{dotted path + '.lora_a' | '.lora_b': array}: JAX's checkpoint
    names and shapes (a slice's adapters gathered whole over the model
    axis, so every rank of a model row calls it).  ``leaves`` ({that path:
    tensor}, the adapters' gradients) are gathered in place of the
    tree's own values."""
    out = {}
    for path, node in _walk(params):
        if "lora_a" in node:
            dim, tp = _shard.split_of(node)
            for k in ADAPTER_KEYS:
                t = (node[k] if leaves is None
                     else leaves[f"{path}.{k}"]).detach()
                if (k, dim) in (("lora_a", 0), ("lora_b", 1)):
                    t = _mesh.all_gather_last(t, tp, dim=dim)
                out[f"{path}.{k}"] = t.float().cpu() \
                    .numpy().copy()  # a copy: training updates in place
    return out


def load_adapters(params, flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``extract_adapters`` onto an adapter-carrying tree:
    each whole adapter (a slice's: its rank's slice of it) copied into its
    leaf in place (an optimizer holding the leaves keeps them).  Raises on
    a path either side lacks, as ``convert.load_flat``."""
    nodes = {path: node for path, node in _walk(params) if "lora_a" in node}
    mine = {f"{p}.{k}" for p in nodes for k in ADAPTER_KEYS}
    if mine != set(flat):
        raise KeyError(f"trees differ: {sorted(mine ^ set(flat))[:8]}")
    with torch.no_grad():
        for path, node in nodes.items():
            whole = {k: torch.from_numpy(np.array(flat[f"{path}.{k}"]))
                     for k in ADAPTER_KEYS}
            for k, v in _slices(node, whole, node["lora_a"].device).items():
                node[k].copy_(v)
    return params
