"""One rank's slice of a llama-family parameter tree (the port's
counterpart of ``bergen_tpu/models/llama.py``'s ``_linear_specs`` :1349,
``param_shardings`` :1376 and ``cache_shardings`` :259).

Column-parallel (the output dimension split over the ``model`` axis): q,
k, v, gate, up and ``lm_head``; row-parallel (the input dimension): o and
down.  The embedding and the norms are replicated.  A packed int4 leaf is
sliced as its dense kernel would be: ``kernel_q4p``'s K/2 rows (rank r's
rows are the codes of its K/tp input rows, two a byte) and
``kernel_scale4``'s groups; a bias follows ``_linear_specs``: split with a
column-parallel output, whole beside a row-parallel one (added once, after
the sum over ranks).  Every sliced node keeps its whole ``[K, N]`` as
``tp_shape`` (Python ints), from which ``models/llama.py`` tells a
row-parallel product (its partial sums meet in an all-reduce) and takes
the JAX package's routing rule on the whole shape, as JAX's model code
sees it.

Dimensions that tp does not divide follow JAX's rule (``jax_llm.py
:143-150``: the leaf is replicated) where that gives the same answer: an
``lm_head`` whose vocabulary tp does not divide stays whole on every rank,
and k and v stay whole when tp does not divide the KV heads (JAX's
engines replicate that cache, ``bergen_tpu/serve/engine.py:110-121``);
each rank then keeps the KV heads its query heads read
(``ShardConfig.kv_heads_kept``).  Query heads, the MLP width and the int4
groups of a row-parallel leaf must divide, or ``shard_llama`` raises.

LoRA adapters follow ``_linear_specs`` (JAX ``llama.py:1367-1370``):
``lora_a`` [d_in, r] is split by rows beside a row-parallel kernel and
whole beside a column-parallel one, ``lora_b`` [r, d_out] split by
columns beside a column-parallel kernel and whole beside a row-parallel
one, ``lora_scale`` whole (``adapter_piece``).

Mixtral's experts (JAX ``llama.py:1400-1409``): the expert axis is split,
never an expert.  Rank r keeps experts ``[r * E/tp, (r+1) * E/tp)``, each
whole, and the whole router, whose top-k stays over all E experts; its
MoE block's f32 partial over its experts meets the other ranks' in an
all-reduce (``models/llama.py::_moe``).  Where tp does not divide E, JAX
replicates the expert stacks (``jax_llm.py:143-150``), so every rank
keeps every expert and sums nothing.  The experts arrive as lists of views
of the mapped checkpoint (``convert.llama_from_hf``) and a rank stacks only
its own (``convert.stack``).  Attention is sliced as for llama;
a MoE layer has no ``mlp`` node, and its ``intermediate_size`` (an
expert's width) is not divided.

An int8 or W8A8 leaf (``convert.quantize_tree_int8``: ``kernel_q`` [K,
N] and the per-column ``kernel_scale`` or ``kernel_scale_a8``; or
``convert.prepare_w8a8``'s ``kernel_q_t`` [N', K] with the scales and bias
padded to N' and ``n_out`` = N) is sliced as its dense kernel would be:
by columns the codes, scales and bias (a W8A8 slice re-padded to whole
128-column tiles of its own N / tp), by rows the codes alone, each
column's scale whole.  The scale spans the whole column (JAX quantizes the
whole tree, ``bergen_tpu/models/convert.py:427``), so a slice of a
quantized tree is what ``quantize_tree_int8`` gives on the slice of the
dense tree, which takes the column maxima over the model axis for a
row-parallel slice.

A packed int4 slice launches the int4 kernel wherever the whole
projection takes it, so it must lie inside the kernels' shapes
(``int4_matmul.launchable``: N a multiple of 128), and so must a dense
slice that ``convert.quantize_tree_int4`` packs after slicing (``int4``,
as ``LLM`` shards before it quantizes).  An int4 ``lm_head`` whose column
slice does not (SOLAR's and Llama-2-70B's 32,000 columns over 4 or 8
ranks: 8,000 or 4,000) stays whole, as a vocabulary tp does not divide
does; any other such slice raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from bergen_tpu_torch.models import convert
from bergen_tpu_torch.ops import int4_matmul

Params = Dict[str, Any]

ROW = ("o", "down")  # the row-parallel projections; the rest by columns
_LINEAR_KEYS = {"kernel", "bias", "kernel_q4p", "kernel_scale4", "tp_shape",
                "kernel_q", "kernel_scale", "kernel_scale_a8", "kernel_q_t",
                "n_out", "lora_a", "lora_b", "lora_scale"}
_COLUMN_SCALES = ("kernel_scale", "kernel_scale_a8")


def kept_kv_heads(num_heads: int, num_kv_heads: int, tp: int,
                  model_rank: int) -> tuple[int, ...] | None:
    """The KV heads rank ``model_rank`` reads when tp does not divide them
    (None: they are sharded).  Its query heads are ``[r * H/tp, (r+1) *
    H/tp)``, each reading KV head ``h // (H / KH)``: one head when those
    query heads lie in one group, else one KV head a query head (a local
    group of 1), so that every local group has one width."""
    if num_kv_heads % tp == 0:
        return None
    per = num_heads // tp
    group = num_heads // num_kv_heads
    first = model_rank * per
    if group % per == 0:
        return (first // group,)
    return tuple((first + h) // group for h in range(per))


def expert_range(num_experts: int, tp: int,
                 model_rank: int) -> tuple[int, int]:
    """(first expert, expert count) of rank ``model_rank``: its E/tp
    experts, or all of them where tp does not divide E (JAX replicates)."""
    if num_experts % tp:
        return 0, num_experts
    per = num_experts // tp
    return model_rank * per, per


def local_config(cfg, tp: int, model_rank: int):
    """``cfg`` as rank ``model_rank`` of ``tp`` sees it (a
    ``llama.ShardConfig``): its query heads, its KV heads and its MLP
    width (a MoE config's expert width whole, its experts in
    ``expert_first`` / ``expert_count``), the head width kept, and
    ``tp``."""
    H, KH, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    E = cfg.num_experts
    if H % tp or (not E and I % tp):
        raise ValueError(
            f"tp={tp} must divide num_heads ({H}) and intermediate_size "
            f"({I})")
    from bergen_tpu_torch.models.llama import LlamaConfig, ShardConfig

    kept = kept_kv_heads(H, KH, tp, model_rank)
    first, count = expert_range(E, tp, model_rank) if E else (0, 0)
    whole = {f.name: getattr(cfg, f.name)
             for f in dataclasses.fields(LlamaConfig)}
    return ShardConfig(**dict(
        whole, num_heads=H // tp,
        num_kv_heads=KH // tp if kept is None else len(kept),
        intermediate_size=I if E else I // tp,
        head_dim_override=cfg.head_dim),
        tp=tp, kv_heads_kept=kept, expert_first=first, expert_count=count)


def _whole(node: Params) -> tuple[int, int]:
    """The [K, N] of a node's own leaves (a slice's, if sliced)."""
    for key in ("kernel", "kernel_q"):
        if key in node:
            return tuple(node[key].shape)
    if "kernel_q_t" in node:
        Np, K = node["kernel_q_t"].shape
        return K, node.get("n_out", Np)
    return node["kernel_q4p"].shape[0] * 2, node["kernel_q4p"].shape[1]


def _check_linear(node: Params, where: str) -> None:
    extra = set(node) - _LINEAR_KEYS
    if extra:
        raise NotImplementedError(
            f"{where}: leaves {sorted(extra)} under tensor parallelism")


def split_of(node: Params) -> tuple[int | None, int]:
    """(the kernel's split dimension: 0 for a row-parallel slice, 1 for a
    column-parallel one, None for a whole leaf; tp) of a linear node."""
    if "tp_shape" not in node:
        return None, 1
    K, N = _whole(node)
    tK, tN = node["tp_shape"]
    return (0, tK // K) if K != tK else (1, tN // N)


def adapter_piece(key: str, t: torch.Tensor, dim: int | None, tp: int,
                  r: int) -> torch.Tensor:
    """Rank ``r``'s slice of a whole LoRA leaf of a node split along
    ``dim`` (JAX's ``_linear_specs``): ``lora_a`` [d_in, rank] by rows
    with a row-parallel kernel, ``lora_b`` [rank, d_out] by columns with a
    column-parallel one; otherwise (and ``lora_scale``) whole."""
    if key == "lora_a" and dim == 0:
        return _piece(t, 0, tp, r)
    if key == "lora_b" and dim == 1:
        return _piece(t, 1, tp, r)
    return t.clone()


def replicated_paths(tree: Params) -> List[str]:
    """The dotted paths (``convert.flatten_paths``) of a rank's tensor
    leaves that every rank of its model row holds whole: the embedding,
    the norms, the router, a whole node's leaves (a head tp does not
    divide, k and v when tp does not divide the KV heads), a row-parallel
    slice's bias and ``lora_b``, a column-parallel slice's ``lora_a``,
    every ``lora_scale``, and expert stacks tp does not divide."""
    out: List[str] = []

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out.append(path)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        elif isinstance(node, dict) and "router" in node:  # a MoE node
            E = node["router"]["kernel"].shape[-1]
            walk(node["router"], f"{path}.router")
            out.extend(f"{path}.{n}.kernel" for n in ("gate", "up", "down")
                       if node[n]["kernel"].shape[0] == E)
        elif isinstance(node, dict) and "tp_shape" in node:
            dim, _ = split_of(node)
            whole = {"lora_scale"} | ({"bias", "lora_b", *_COLUMN_SCALES}
                                      if dim == 0 else {"lora_a"})
            out.extend(f"{path}.{k}" for k in node if k in whole)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(tree, "")
    return out


def _launches(node: Params, tp: int, int4: bool) -> bool:
    """False where the whole int4 projection (packed, or dense and packed
    after slicing: ``int4``) takes the kernel (``int4_matmul.supports`` on
    the whole shape: the route its slices take, ``models/llama.py``) and
    its column slice over tp ranks falls outside the kernels' shapes.  A
    row slice of whole groups keeps the group and N, so it stays inside."""
    K, N = _whole(node)
    if "kernel_q4p" in node:
        groups = node["kernel_scale4"].shape[0]
    elif int4 and convert.int4_quantizes(K, N):
        groups = K // convert.INT4_GROUP
    else:
        return True
    return not int4_matmul.supports(K, N, groups) or \
        int4_matmul.launchable(K, N // tp, groups)


def _piece(t: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).clone(memory_format=torch.contiguous_format)


def _column(node: Params, tp: int, r: int, where: str,
            int4: bool = False) -> Params:
    _check_linear(node, where)
    K, N = _whole(node)
    if not _launches(node, tp, int4):
        raise ValueError(
            f"{where}: its int4 slice of {N // tp} of {N} columns is outside "
            "the int4 kernels' shapes (a multiple of 128 columns)")
    out: Params = {"tp_shape": [K, N]}
    if "kernel_q_t" in node:
        return _w8a8_column(node, out, K, N, tp, r, where)
    for key, t in node.items():
        if key.startswith("lora_"):
            out[key] = adapter_piece(key, t, 1, tp, r)
        elif key != "tp_shape":
            out[key] = _piece(t, t.dim() - 1, tp, r)
    return out


def _w8a8_column(node: Params, out: Params, K: int, N: int, tp: int, r: int,
                 where: str) -> Params:
    """A column slice of a prepared W8A8 leaf: rank r's N / tp rows of
    ``kernel_q_t`` and entries of its scale and bias, re-padded with zeros
    to whole 128-column tiles (``convert.prepare_w8a8`` on the slice)."""
    if N % tp:
        raise ValueError(f"{where}: tp={tp} does not divide its {N} columns")
    n = N // tp
    Np = convert.w8a8_rows(n)
    lo = r * n
    w_t = node["kernel_q_t"]
    piece = torch.zeros(Np, K, dtype=w_t.dtype, device=w_t.device)
    piece[:n] = w_t[lo:lo + n]
    out["kernel_q_t"] = piece
    for key in ("kernel_scale_a8", "bias"):
        if key in node:
            v = node[key]
            out[key] = torch.cat([v[lo:lo + n], v.new_zeros(Np - n)])
    if Np != n:
        out["n_out"] = n
    return out


def _row(node: Params, tp: int, r: int, where: str) -> Params:
    _check_linear(node, where)
    K, N = _whole(node)
    groups = node["kernel_scale4"].shape[0] if "kernel_scale4" in node else 0
    if groups % tp:
        raise ValueError(
            f"{where}: tp={tp} does not divide its {groups} int4 groups")
    out: Params = {"tp_shape": [K, N]}
    for key, t in node.items():
        if key.startswith("lora_"):
            out[key] = adapter_piece(key, t, 0, tp, r)
        elif key in ("kernel", "kernel_q4p", "kernel_scale4", "kernel_q"):
            out[key] = _piece(t, 0, tp, r)
        elif key == "kernel_q_t":  # [N', K]: the input rows are columns
            out[key] = _piece(t, 1, tp, r)
        elif key in ("bias", "n_out") + _COLUMN_SCALES:
            out[key] = t.clone() if isinstance(t, torch.Tensor) else t
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _experts(moe: Params, local, where: str) -> Params:
    """A rank's MoE node: the whole router, and its experts stacked out of
    the checkpoint's views (``convert.stack``), or sliced out of stacks
    already made."""
    _check_linear(moe["router"], f"{where}.router")
    first, count = local.expert_first, local.expert_count
    out: Params = {"router": _copy(moe["router"])}
    for name in ("gate", "up", "down"):
        experts = moe[name]["kernel"]
        out[name] = {"kernel": convert.stack(experts, first, count)
                     if isinstance(experts, list)
                     else experts[first:first + count].clone()}
    return out


def shard_llama(params: Params, cfg, tp: int, model_rank: int,
                int4: bool = False):
    """(rank ``model_rank``'s slice of ``params``, its ``local_config``);
    ``int4``: the slice is packed next (``convert.quantize_tree_int4``).
    Each slice is a contiguous copy, so that a tree of views of the mapped
    checkpoint (``convert.load_checkpoint``) copies only this rank's bytes
    of a sharded leaf."""
    local = local_config(cfg, tp, model_rank)
    r = model_rank
    out: Params = {"embed": params["embed"].clone(),
                   "final_norm": _copy(params["final_norm"]), "layers": []}
    for li, layer in enumerate(params["layers"]):
        entry = {k: _copy(v) for k, v in layer.items()
                 if k not in ("attn", "mlp", "moe")}
        attn = {}
        for n in ("q", "k", "v", "o"):
            where = f"layers.{li}.attn.{n}"
            if n in ("k", "v") and local.kv_heads_kept is not None:
                _check_linear(layer["attn"][n], where)
                attn[n] = _copy(layer["attn"][n])  # replicated, as JAX
            elif n == "o":
                attn[n] = _row(layer["attn"][n], tp, r, where)
            else:
                attn[n] = _column(layer["attn"][n], tp, r, where, int4)
        entry["attn"] = attn
        if "moe" in layer:
            entry["moe"] = _experts(layer["moe"], local, f"layers.{li}.moe")
            out["layers"].append(entry)
            continue
        mlp = layer["mlp"]
        entry["mlp"] = {
            n: _row(mlp[n], tp, r, f"layers.{li}.mlp.{n}") if n in ROW
            else _column(mlp[n], tp, r, f"layers.{li}.mlp.{n}", int4)
            for n in ("gate", "up", "down")}
        out["layers"].append(entry)
    if "lm_head" in params:
        head = params["lm_head"]
        if _whole(head)[1] % tp or not _launches(head, tp, int4):
            _check_linear(head, "lm_head")
            out["lm_head"] = _copy(head)  # replicated, as JAX
        else:
            out["lm_head"] = _column(head, tp, r, "lm_head", int4)
    return out, local


def unshard_llama(shards: List[Params]) -> Params:
    """The whole tree back from every rank's slice, in rank order: each
    sliced leaf joined along its split dimension, every other leaf rank
    0's."""
    def join(nodes):
        first = nodes[0]
        if isinstance(first, list):
            return [join([n[i] for n in nodes]) for i in range(len(first))]
        if not isinstance(first, dict):
            return first
        if "router" in first:  # a MoE node: the experts joined, if split
            E = first["router"]["kernel"].shape[-1]
            return {name: {"kernel": torch.cat(
                        [n[name]["kernel"] for n in nodes])
                        if first[name]["kernel"].shape[0] < E
                        else first[name]["kernel"]}
                    if name != "router" else first[name] for name in first}
        if "tp_shape" not in first:
            return {k: join([n[k] for n in nodes]) for k in first}
        K = _whole(first)[0]
        row = K != first["tp_shape"][0]
        if "kernel_q_t" in first and not row:
            raise NotImplementedError(
                "unshard_llama: a column-sliced prepared W8A8 leaf (join "
                "the kernel_q slices before convert.prepare_w8a8)")
        out = {}
        for key, t in first.items():
            if key == "tp_shape":
                continue
            if key == "lora_scale" or key == ("lora_b" if row else "lora_a"):
                out[key] = t  # whole on every rank
            elif key == "kernel_q_t":
                out[key] = torch.cat([n[key] for n in nodes], dim=1)
            elif row and key in ("bias", "n_out") + _COLUMN_SCALES:
                out[key] = t
            else:
                out[key] = torch.cat([n[key] for n in nodes],
                                     dim=0 if row else t.dim() - 1)
        return out

    return join(shards)
