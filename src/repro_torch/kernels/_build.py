"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries are
built at first use into ``build/torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, the headers
beside it and the flags, so an edited source is rebuilt; beside each
library lies its compiler log (``build_log``: ``-Xptxas -v``'s registers,
shared memory and spills).  ``build_all`` starts one ``nvcc`` per source,
all at once.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code.  ``launch_counts`` holds one integer per kernel,
incremented by the wrapper exactly where it launches (``count``); one
library may hold several kernels, each with its own count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

import torch

_HERE = pathlib.Path(__file__).resolve().parent

# -fmad=false: no contraction beyond the __fmaf_rn calls written out — the
# z stream is bitwise-specified (see zo_fused/csrc/zo_stream.cuh)
_NO_FMAD = ("-fmad=false",)

#: library name -> (source relative to this package, extra nvcc flags,
#: the kernels it launches — one launch count each)
SOURCES: Dict[str, tuple] = {
    "zo_affine": ("zo_fused/csrc/zo_affine.cu", _NO_FMAD, ("zo_affine",)),
    "zo_multi": ("zo_fused/csrc/zo_multi.cu", _NO_FMAD,
                 ("zo_affine_chain", "zo_affine_multi", "zo_affine_batched")),
    "zo_sqnorm": ("zo_fused/csrc/zo_sqnorm.cu", _NO_FMAD, ("zo_sqnorm",)),
    "zo_rows": ("zo_fused/csrc/zo_rows.cu", _NO_FMAD,
                ("zo_affine_rows", "zo_affine_multi_rows",
                 "zo_affine_chain_rows", "zo_sqnorm_rows")),
    "zo_threefry": ("threefry/csrc/zo_threefry.cu", _NO_FMAD,
                    ("zo_affine_threefry", "zo_affine_threefry_original")),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu", (),
                        ("flash_attention",)),
    "paged_gather": ("paged/csrc/paged_gather.cu", (), ("paged_gather",)),
    # K11 is held to a tolerance, not to its bits: contraction allowed
    "wkv6": ("rwkv6/csrc/wkv6.cu", (), ("wkv6_chunked",)),
}
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the library's build log (``build_log``)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: Dict[str, int] = {k: 0 for _, _, ks in SOURCES.values()
                                 for k in ks}
#: launches by route, for a kernel whose wrapper picks one of several device
#: functions: "kernel/route" -> count (K2: its bf16 and f32 routes, and
#: each launch once more under its head dim, "flash_attention/hd128")
route_counts: Dict[str, int] = {}
#: calls that launch no kernel but belong to one's path, counted apart from
#: its launches: K11's backward (the VJP of its plain chunk form, recomputed
#: under autograd — JAX differentiates its jnp chunk graph the same way)
record_counts: Dict[str, int] = {"wkv6_chunked_backward": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}


def record(name: str) -> None:
    record_counts[name] += 1


def count(name: str, *routes: str) -> None:
    launch_counts[name] += 1
    for route in routes:
        key = f"{name}/{route}"
        route_counts[key] = route_counts.get(key, 0) + 1


def local(t):
    """A DTensor's local shard (the rank's own tensor), else ``t``."""
    return t.to_local() if hasattr(t, "placements") else t


def on_meta(t) -> bool:
    """A ``meta`` tensor, or a DTensor whose shard is one: a wrapper's
    shape rule (a dry run's trace) — it returns the result's shape,
    charges ``analysis.costs`` with the local shard and launches
    nothing."""
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def empty_streams(x, n: int):
    """A shape rule's result for ``n`` streams of ``x``: an empty
    ``(n, *x.shape)`` tensor made by an allocator alone, so a dry run counts
    no traffic for it (the card's route only allocates too).  A DTensor's
    shard dims move one to the right, as ``torch.stack`` would place them."""
    if not hasattr(x, "placements"):
        return x.new_empty((n,) + tuple(x.shape))
    from torch.distributed.tensor import DTensor, Shard
    shard = x.to_local()
    shape = torch.Size((n,) + tuple(x.shape))
    return DTensor.from_local(
        shard.new_empty((n,) + tuple(shard.shape)), x.device_mesh,
        [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def refuse_autograd(kernel: str, tensors, instead: str) -> None:
    """Raise where autograd would record through ``kernel``: a ctypes launch
    writes into fresh tensors with no ``grad_fn``, so a gradient would stop
    there without a word.  Called by a wrapper with no backward before it
    launches (K2: JAX's Pallas flash has none either); ``instead`` names
    what differentiates."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: autograd cannot differentiate "
            f"through it (an input requires grad); use {instead}, or call "
            "it under torch.no_grad()")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    for k in record_counts:
        record_counts[k] = 0
    route_counts.clear()


def build_dir() -> pathlib.Path:
    return _HERE.parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> pathlib.Path:
    src, extra, _ = SOURCES[name]
    h = hashlib.sha256((_HERE / src).read_bytes())
    for header in sorted((_HERE / src).parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(repr((_FLAGS, extra)).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library, one ``nvcc`` per source started
    together; returns the wall seconds taken.  Raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    names = list(SOURCES if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        src, extra, _ = SOURCES[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *extra, "-o", str(tmp), str(_HERE / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib_path(name: str) -> pathlib.Path:
    """The library's path, built first if needed."""
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    return path


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) from the build of ``name``."""
    return lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (cached per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s card, read without
    building a ``torch.cuda.Stream`` (which costs a few µs a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
