"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``.  All
sources build together (one nvcc process each, started at once) on the first
CUDA launch of any kernel, into ``bergen_tpu_torch/_build/<hash>/``, keyed by
a hash of every source; importing the package builds nothing, so the CPU
path needs no CUDA toolkit.  A build holds a file lock beside its folder,
so that the ranks of a tensor-parallel run, which reach their first launch
together, build once: one process compiles, the others wait and load.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> (library, argtypes)
SIGNATURES = {
    "encoder_gemm": ("encoder_layer", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _P]),
    "encoder_gemm_tile_n": ("encoder_layer", [_I, _I]),
    "encoder_attention": ("encoder_layer", [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _F, _P]),
    "encoder_attention_qkv": ("encoder_layer", [_P] * 6 + [_I] * 4
                              + [_F, _P]),
    "encoder_layernorm": ("encoder_layer", [_P, _P, _P, _P, _P, _I, _I, _F,
                                            _P]),
    "encoder_rowquant": ("encoder_layer_q", [_P, _I, _P, _P, _P] + [_I] * 3
                         + [_P]),
    "encoder_layernorm_q": ("encoder_layer_q", [_P] * 6 + [_I, _I, _F, _P]),
    "encoder_rowmax": ("encoder_layer_q", [_P, _P, _I, _I, _P]),
    "encoder_qgemm": ("encoder_layer_q", [_P] * 8 + [_I] * 6 + [_P]),
    "bin_topk_bins": ("bin_topk", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "bin_topk_bins_i8": ("bin_topk", [_P] * 5 + [_I] * 5 + [_P]),
    "decode_attention": ("decode_attention", [_P] * 8 + [_I] * 6 + [_F, _P]),
    "decode_attention_splits": ("decode_attention", [_I] * 5),
    "int4_matmul": ("int4_matmul", [_P] * 7 + [_I] * 4 + [_P]),
    "int4_decode_splits": ("int4_matmul", [_I] * 3),
    "flash_attention": ("flash_attention", [_P] * 5 + [_I] * 11 + [_F, _P]),
    "paged_partial": ("paged_attention", [_P] * 12 + [_I] * 7 + [_F, _P]),
    "paged_partial_blocks_per_sm": ("paged_attention", []),
    "flash_attention_band": ("flash_band", [_P] * 5 + [_I] * 7 + [_L, _L, _F,
                                                                 _P]),
    "pallas_score": ("score", [_P] * 3 + [_I] * 3 + [_P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels need the CUDA toolkit to build")


@contextlib.contextmanager
def _locked(folder: str):
    """An exclusive lock on ``<folder>.lock`` (across processes) while the
    block runs."""
    os.makedirs(os.path.dirname(folder), exist_ok=True)
    with open(folder + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> str:
    """Compile every ``csrc/*.cu`` not yet built, in parallel; returns the
    build directory.  nvcc's resource report (-Xptxas -v) for each source is
    kept beside its library as ``<name>.log``.  Processes that call it
    together build once (``_locked``)."""
    out = os.path.join(BUILD_ROOT, _digest())
    if all(os.path.exists(os.path.join(out, os.path.basename(s)[:-3]
                                       + ".so")) for s in _sources()):
        return out
    with _locked(out):
        _build_missing(out)
    return out


def _build_missing(out: str) -> None:
    todo = [s for s in _sources() if not os.path.exists(
        os.path.join(out, os.path.basename(s)[:-3] + ".so"))]
    if not todo:
        return
    os.makedirs(out, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        name = os.path.basename(src)[:-3]
        tmp = os.path.join(out, f"{name}.{os.getpid()}.tmp.so")
        log = open(os.path.join(out, f"{name}.log"), "w")
        procs.append((name, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, os.path.join(out, f"{name}.so"))
    if failed:
        logs = "\n".join(open(os.path.join(out, f"{n}.log")).read()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def host_library(src: str, flags: list[str], stem: str) -> ctypes.CDLL:
    """The host C++ source ``src`` (a library of ``native/``) built with g++
    and ``flags`` into ``_build/<stem>-<hash>/lib<stem>.so`` on first use
    (keyed by the source and the flags) and loaded; raises if it cannot be
    built or loaded."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()) \
            .hexdigest()[:16]
    out = os.path.join(BUILD_ROOT, f"{stem}-{digest}")
    so = os.path.join(out, f"lib{stem}.so")
    if not os.path.exists(so):
        with _locked(out):
            if not os.path.exists(so):
                os.makedirs(out, exist_ok=True)
                tmp = os.path.join(out, f"lib{stem}.{os.getpid()}.tmp.so")
                res = subprocess.run(["g++", *flags, "-o", tmp, src],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"building {src} failed:\n"
                                       f"{res.stderr[-4000:]}")
                os.replace(tmp, so)
    return ctypes.CDLL(so)


def function(name: str):
    """The ctypes function for C entry ``name``, building on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    lib_name, argtypes = SIGNATURES[name]
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            lib = ctypes.CDLL(os.path.join(build_all(), f"{lib_name}.so"))
            _libs[lib_name] = lib
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _fns[name] = fn
    return fn


_counters: dict = {}


def counters(name: str, device, n: int):
    """A zeroed int32 tensor of at least ``n`` entries on ``device``, kept
    for the process: the cross-block counters of kernel ``name``, which
    every launch leaves fit for the next (allocated and zeroed once, not
    per launch).  Launches that share it must be on one stream."""
    import torch

    key = (name, str(device))
    t = _counters.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = t
    return t


_scratch: dict = {}


def scratch(name: str, device, n: int):
    """An f32 tensor of at least ``n`` entries on ``device``, kept for the
    process and grown as needed: the partial results that one launch of
    kernel ``name`` writes and reads back before it ends, so that a
    launch-bound decode step allocates nothing per call.  Launches that
    share it must be on one stream."""
    import torch

    key = (name, str(device))
    t = _scratch.get(key)
    if t is None or t.numel() < n:
        t = torch.empty(n, dtype=torch.float32, device=device)
        _scratch[key] = t
    return t


def refuse_grad(fn: str, *args) -> None:
    """Raise if a tensor handed to kernel wrapper ``fn`` on the card (an
    argument, or a value of a dict argument) requires grad: no kernel
    defines a backward, so a differentiated forward must take the plain
    PyTorch route (the JAX package's kernels define no VJP either).  The
    wrapper raises rather than give way to its plain version."""
    for a in args:
        for t in (a.values() if isinstance(a, dict) else (a,)):
            if getattr(t, "requires_grad", False):
                raise RuntimeError(
                    f"{fn}: handed a tensor that requires grad; the CUDA "
                    "kernel has no backward (a differentiated forward takes "
                    "the plain PyTorch route)")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
