"""Process groups for the ``('data', 'model')`` grid (the PyTorch port's
counterpart of ``bergen_tpu/parallel/mesh.py``).

The JAX package puts every device of one host in a ``('data', 'model')``
mesh and lets XLA insert the collectives.  The port runs one process per
card, launched by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``: ``init`` joins those processes into one
``torch.distributed`` group (NCCL on the cards, each rank on
``cuda:LOCAL_RANK``; gloo on the CPU), and ``get_mesh(data, model)``
builds JAX's grid over them with JAX's asserts: ``devices.reshape(data,
model)``, so model row ``d`` is ranks ``d * model ... d * model + model -
1`` and data column ``m`` the ranks with ``rank % model == m``.  Each grid
carries one process group for its rank's model row and one for its data
column (``dist.new_group``: every group made on every rank, in the same
order, the first time the grid is asked for).

Two kinds of collective run over them:

* over the ``model`` axis, where the generator's tensor-parallel products
  meet (``all_reduce_sum``, ``all_reduce_max``, ``all_gather_last``): the
  rank's model row of the grid whose model axis is ``tp``.  Training
  differentiates through three of them, each an autograd Function that
  works out of place (an in-place ``copy_`` back into a tensor of the
  graph would cut its gradient): ``copy_in`` (forward the identity,
  backward the sum), ``reduce_out`` (forward the sum, backward the
  identity) and ``gather_last`` (forward the all-gather, backward the
  rank's slice).  Without autograd they are the identity, the in-place
  ``all_reduce_sum`` and ``all_gather_last``;
* over the ``data`` axis of ``get_mesh()`` (data = every rank), where the
  encoders, the reranker and the retrieval engines run data-parallel:
  ``all_gather_rows`` (equal shards joined in rank order), ``data_rows``
  (a batch padded to the ranks, each rank's contiguous rows run, the
  outputs gathered), ``data_shard`` (a rank's rows of a padded corpus) and
  ``broadcast_object``.

A grid with ``data * model`` below the world passes JAX's assert, but no
call site builds one: it raises.  Without a ``torchrun`` environment the
world is 1: no process group is made and every path runs as in one
process.  Placing every rank on one card (``device='cuda:0'``) needs
``backend='gloo'`` from the caller; NCCL refuses two ranks on one device,
and ``init`` raises rather than fall back.  On gloo a collective on a CUDA
tensor moves through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from bergen_tpu_torch import device as _device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``('data', 'model')`` grid: ``rank`` and
    ``world`` over all processes, its device, the process group's backend,
    and the groups of its model row and data column (None: the whole
    world, or the rank alone where that axis has size 1)."""
    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: str | None = None
    model_group: Any = None
    data_group: Any = None

    @property
    def data_rank(self) -> int:
        """This rank's place along the data axis (its model row)."""
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        """This rank's place along the model axis (its data column)."""
        return self.rank % self.model


_WORLD: Mesh | None = None   # set by init when the world is larger than 1
_GRIDS: dict = {}            # (data, model) -> this rank's Mesh


def world_size() -> int:
    """The number of ranks: the process group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank: the process group's, else torchrun's ``RANK``,
    else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


_rank = rank


def _rank_device(device, local_rank: int, backend: str | None):
    asked = torch.device("cuda" if device is None else device)
    if asked.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs CUDA devices; the CPU "
                             "ranks take gloo")
        return asked, backend or "gloo"
    if asked.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if asked.index is not None and backend != "gloo":
        # every rank on the one card named: only gloo takes that
        raise ValueError(
            f"every rank on {asked}: NCCL refuses two ranks on one device; "
            "pass backend 'gloo' (CLI: dist_backend=gloo) to share one "
            "card, or device 'cuda' for one card a rank")
    if not torch.cuda.is_available():
        _device.resolve("cuda")  # raises, naming device=cpu
    if asked.index is not None:
        return asked, backend
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} but this host has {n} card(s): run "
            "one rank a card (torchrun --nproc-per-node <cards>)")
    return torch.device("cuda", local_rank), backend or "nccl"


def init(device=None, backend: str | None = None,
         init_method: str | None = None, rank: int | None = None,
         world: int | None = None,
         timeout: datetime.timedelta | None = None) -> Mesh:
    """This rank's ``Mesh`` over every process (the grid of one model row
    of every rank).

    World 1 (no ``torchrun`` environment, no arguments): no process group,
    the device resolved as every entry point resolves it.  Otherwise the
    process group is joined once (``init_method`` default ``env://``, or
    an existing group is taken as it is) and the same Mesh is returned to
    every later call."""
    global _WORLD
    if _WORLD is not None:
        return _WORLD
    world = world or world_size()
    if world == 1:
        return Mesh(1, 1, 0, 1, _device.resolve(device))
    rank = _rank() if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev, backend = _rank_device(device, local_rank, backend)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("an NCCL process group with CPU ranks")
    else:
        # the other ranks wait in a collective while rank 0 alone runs a
        # host stage (dataset or context processing, rag.py), which can
        # take hours at scale
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=timeout or datetime.timedelta(hours=12))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _WORLD = Mesh(1, world, rank, world, dev, backend)
    return _WORLD


def get_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The ``('data', 'model')`` grid over every rank, with JAX's asserts
    (``bergen_tpu/parallel/mesh.py:26-40``): ``data=None`` takes every
    rank over ``model``.  The first call for a grid makes its groups, so
    every rank makes it, in the same order; a grid that leaves ranks out
    raises.  At world 1 (no process group) the one-rank grid, its device
    unresolved."""
    if _WORLD is None and world_size() == 1:
        assert model == 1 and data in (None, 1), \
            f"mesh {data}x{model} > 1 ranks"
        return Mesh(1, 1, 0, 1, None)
    base = init()
    n = base.world
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model <= n, f"mesh {data}x{model} > {n} ranks"
    if data * model != n:
        raise NotImplementedError(
            f"a {data}x{model} grid over {n} ranks leaves ranks out of the "
            "mesh; no call site builds one (ROADMAP.md Queue 1 #10, "
            "multi-GPU)")
    if model == n:
        return base
    if (data, model) not in _GRIDS:
        _GRIDS[data, model] = _grid(base, data, model)
    return _GRIDS[data, model]


def _grid(base: Mesh, data: int, model: int) -> Mesh:
    """``base``'s rank in a ``data x model`` grid of every rank: one group
    a model row and one a data column (the whole world for data = world),
    each made on every rank in the same order."""
    rows = [dist.new_group(list(range(d * model, (d + 1) * model)))
            for d in range(data)] if model > 1 else [None] * data
    cols = [dist.new_group(list(range(m, data * model, model)))
            for m in range(model)] if model > 1 else [None]
    r = base.rank
    return Mesh(data, model, r, base.world, base.device, base.backend,
                rows[r // model], cols[r % model])


def _model_axis(tp: int | None) -> Mesh:
    """The grid whose model axis is ``tp`` (None: the world's one row)."""
    if _WORLD is None:
        raise RuntimeError("no process group: the collectives run on a "
                           "world of ranks (mesh.init under torchrun)")
    return _WORLD if tp is None or tp == _WORLD.world else get_mesh(model=tp)


def _through_host(t: torch.Tensor, m: Mesh) -> bool:
    return m.backend == "gloo" and t.is_cuda


def _on_backend(t: torch.Tensor, m: Mesh) -> torch.Tensor:
    """``t`` where the backend takes it: host memory on gloo, the rank's
    card on NCCL."""
    if _through_host(t, m):
        return t.contiguous().cpu()
    if m.backend == "nccl" and not t.is_cuda:
        return t.contiguous().to(m.device)
    return t.contiguous()


def _all_reduce(t: torch.Tensor, op, tp: int | None) -> torch.Tensor:
    m = _model_axis(tp)
    src = _on_backend(t, m)
    dist.all_reduce(src, op=op, group=m.model_group)
    if src.data_ptr() != t.data_ptr():
        t.copy_(src)
    return t


def all_reduce_sum(t: torch.Tensor, tp: int | None = None) -> torch.Tensor:
    """``t`` summed over the ``model`` axis of the grid of model ``tp``
    (default: one row of every rank), in place (every rank of the row holds
    the same sum); returns ``t``."""
    return _all_reduce(t, dist.ReduceOp.SUM, tp)


def all_reduce_max(t: torch.Tensor, tp: int | None = None) -> torch.Tensor:
    """``t``'s largest values over the ``model`` axis of the grid of model
    ``tp`` (exact: a max has no order), in place; returns ``t``."""
    return _all_reduce(t, dist.ReduceOp.MAX, tp)


def all_gather_last(t: torch.Tensor, tp: int | None = None,
                    dim: int = -1) -> torch.Tensor:
    """Every ``model`` rank's ``t`` joined along the last dimension (or
    ``dim``), in rank order."""
    m = _model_axis(tp)
    src = _on_backend(t, m)
    parts = [torch.empty_like(src) for _ in range(m.model)]
    dist.all_gather(parts, src, group=m.model_group)
    return torch.cat(parts, dim=dim).to(t.device)


def _summed(t: torch.Tensor, tp: int) -> torch.Tensor:
    """A new tensor: ``t`` summed over the model axis (``t`` untouched)."""
    m = _model_axis(tp)
    src = _on_backend(t, m)
    if src.data_ptr() == t.data_ptr():
        src = src.clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=m.model_group)
    return src.to(t.device)


class _CopyIn(torch.autograd.Function):
    """Forward the identity, backward the sum over the model axis: the
    input of column-parallel slices, whose gradients on each rank cover
    only its columns.  The partials meet in f32 and the sum is rounded
    once to the gradient's dtype, as the forward's row-parallel partials
    are."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g.float(), ctx.tp).to(g.dtype), None


class _ReduceOut(torch.autograd.Function):
    """Forward the sum over the model axis (out of place), backward the
    identity: the partials of row-parallel slices and of the MoE block."""

    @staticmethod
    def forward(ctx, x, tp):
        return _summed(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Forward the all-gather along the last dimension, backward the
    rank's slice of the gradient: the column-parallel head."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        r = _model_axis(ctx.tp).model_rank
        return g.narrow(-1, r * ctx.n, ctx.n).contiguous(), None


def copy_in(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``x`` as the input of a column-parallel slice: itself, and under
    autograd its gradient summed over the model axis of ``tp`` in the
    backward (each rank's covers its own columns)."""
    return _CopyIn.apply(x, tp) if torch.is_grad_enabled() else x


def reduce_out(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``x`` summed over the model axis of ``tp``: in place under
    ``no_grad`` (``all_reduce_sum``, inference), else a new tensor whose
    gradient passes to every rank's partial unchanged."""
    if torch.is_grad_enabled():
        return _ReduceOut.apply(x, tp)
    return all_reduce_sum(x, tp)


def gather_last(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``all_gather_last``; under autograd the gradient's slice of this
    rank flows back to ``x``."""
    if torch.is_grad_enabled():
        return _GatherLast.apply(x, tp)
    return all_gather_last(x, tp)


def data_world() -> int:
    """The ranks of ``get_mesh()``'s data axis: every rank."""
    return world_size() if _WORLD is not None or dist.is_initialized() \
        else 1


def data_rank() -> int:
    """This rank's place on ``get_mesh()``'s data axis."""
    return rank() if data_world() > 1 else 0


def all_gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's ``t`` (equal shapes) joined along ``dim`` in rank
    order, on ``t``'s device; ``t`` itself at world 1."""
    if data_world() == 1:
        return t
    m = get_mesh()
    src = _on_backend(t, m)
    parts = [torch.empty_like(src) for _ in range(m.data)]
    dist.all_gather(parts, src, group=m.data_group)
    return torch.cat(parts, dim=dim).to(t.device)


def data_shard(n_rows: int, align: int = 1) -> tuple[int, int, int]:
    """(padded rows N', this rank's first row, its row count) of ``n_rows``
    padded to a multiple of ``data x align`` (JAX's corpus layouts), each
    data rank holding N' / data contiguous rows."""
    n = data_world()
    Np = -(-n_rows // (n * align)) * n * align
    per = Np // n
    return Np, data_rank() * per, per


def data_rows(fn, *arrays: np.ndarray) -> np.ndarray:
    """``fn(*rows)`` data-parallel over every rank, as the JAX encoders
    shard a batch: the arrays' leading dimension padded to the rank count
    by repeating the last row (``pad_batch_to_devices``), each rank
    running ``fn`` on its contiguous B' / world rows, and the outputs
    (numpy, rows first) gathered in rank order and cut back to B.  At
    world 1, ``fn(*arrays)``."""
    n = data_world()
    if n == 1:
        return fn(*arrays)
    padded = [pad_batch_to_devices(a, n)[0] for a in arrays]
    B = arrays[0].shape[0]
    per = padded[0].shape[0] // n
    lo = data_rank() * per
    out = np.ascontiguousarray(fn(*(a[lo:lo + per] for a in padded)))
    return all_gather_rows(torch.from_numpy(out)).numpy()[:B]


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (``obj`` itself at world 1)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def pad_batch_to_devices(x: np.ndarray, n_shards: int
                         ) -> tuple[np.ndarray, int]:
    """Pad the leading dim so it divides n_shards; returns (padded,
    orig_len)."""
    n = x.shape[0]
    rem = (-n) % n_shards
    if rem:
        pad = np.repeat(x[-1:], rem, axis=0)
        x = np.concatenate([x, pad], axis=0)
    return x, n
