"""The kernel build and binding layer (``bergen_tpu_torch/ops/_build.py``)
on the CPU: every ctypes signature names a C entry of its ``csrc`` source
with as many parameters, and the per-device buffers that the wrappers keep
(cross-block counters, per-launch scratch) are made once and grown, never
per call.  Nothing here needs nvcc or a card."""

from __future__ import annotations

import os
import re

import pytest
import torch

from bergen_tpu_torch.ops import _build


def _c_entries(lib: str) -> dict[str, int]:
    """``extern "C"`` functions of ``csrc/<lib>.cu``: name -> parameter
    count."""
    with open(os.path.join(_build.CSRC, f"{lib}.cu")) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^int (\w+)\(([^)]*)\)", block, re.M):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_entry(name):
    lib, argtypes = _build.SIGNATURES[name]
    entries = _c_entries(lib)
    assert name in entries, f"{name} is not an extern C entry of {lib}.cu"
    assert entries[name] == len(argtypes)


def test_every_source_is_bound():
    libs = {lib for lib, _ in _build.SIGNATURES.values()}
    sources = {os.path.basename(p)[:-3] for p in _build._sources()}
    assert sources == libs


@pytest.mark.parametrize("keep", [_build.scratch, _build.counters])
def test_device_buffers_are_kept_and_grown(keep):
    name = f"test_{keep.__name__}"
    first = keep(name, torch.device("cpu"), 10)
    assert first.numel() >= 10
    again = keep(name, torch.device("cpu"), first.numel())
    assert again.data_ptr() == first.data_ptr()
    grown = keep(name, torch.device("cpu"), first.numel() + 1)
    assert grown.numel() > first.numel()
    assert keep(name, torch.device("cpu"), 1).data_ptr() == grown.data_ptr()
    if keep is _build.counters:
        assert grown.dtype == torch.int32 and not grown.any()
    else:
        assert grown.dtype == torch.float32


def test_digest_follows_the_sources(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("int a() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    d0 = _build._digest()
    (tmp_path / "a.cu").write_text("int a() { return 1; }\n")
    assert _build._digest() != d0
