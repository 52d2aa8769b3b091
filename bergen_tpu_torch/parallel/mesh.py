"""Process groups for tensor parallelism (the PyTorch port's counterpart of
``bergen_tpu/parallel/mesh.py``).

The JAX package puts every device of one host in a ``('data', 'model')``
mesh and lets XLA insert the collectives.  The port runs one process per
card, launched by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``: ``init`` joins those processes into one
``torch.distributed`` group (NCCL on the cards, each rank on
``cuda:LOCAL_RANK``; gloo on the CPU), ``get_mesh`` checks the
``('data', 'model')`` grid asked for with JAX's asserts, and the
collectives below run over the ``model`` axis, where the generator's
tensor-parallel products meet.  Only the grid of one ``model`` row that
spans every rank is ported: the ``data`` axis is ROADMAP.md Queue 1 #10,
part 2.

Without a ``torchrun`` environment the world is 1: no process group is
made and every path runs as in one process.  Placing every rank on one
card (``device='cuda:0'``) needs ``backend='gloo'`` from the caller; NCCL
refuses two ranks on one device, and ``init`` raises rather than fall back.
On gloo a collective on a CUDA tensor moves through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from bergen_tpu_torch import device as _device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ``('data', 'model')`` grid (one ``model`` row
    of every rank): ``rank`` and ``world`` over all processes, its device
    and the process group's backend."""
    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: str | None = None


_WORLD: Mesh | None = None   # set by init when the world is larger than 1


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
    """This rank's ``Mesh`` over every process (a one-row grid: data 1).

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
        # the other ranks wait in a collective while rank 0 runs the stages
        # before generation (rag.py), which can take hours at scale
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
    rank over ``model``.  Only one ``model`` row of every rank is ported;
    any other grid raises."""
    base = init()
    n = base.world
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model <= n, f"mesh {data}x{model} > {n} ranks"
    if (data, model) != (1, n):
        raise NotImplementedError(
            f"a {data}x{model} grid over {n} ranks: only one model row of "
            "every rank is ported; the data axis is ROADMAP.md Queue 1 #10, "
            "multi-GPU")
    return base


def _model_axis() -> Mesh:
    if _WORLD is None:
        raise RuntimeError("no process group: the collectives run on a "
                           "world of ranks (mesh.init under torchrun)")
    return _WORLD


def _through_host(t: torch.Tensor, m: Mesh) -> bool:
    return m.backend == "gloo" and t.is_cuda


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ``model`` axis, in place (every rank holds the
    same sum); returns ``t``."""
    m = _model_axis()
    if _through_host(t, m):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def all_gather_last(t: torch.Tensor) -> torch.Tensor:
    """Every ``model`` rank's ``t`` joined along the last dimension, in
    rank order."""
    m = _model_axis()
    src = t.contiguous().cpu() if _through_host(t, m) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(m.model)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=-1).to(t.device)


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
