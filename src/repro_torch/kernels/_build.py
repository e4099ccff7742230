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
import math
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

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


def live_dtensor(t) -> bool:
    """A DTensor whose shard holds values (not a dry run's ``meta``)."""
    return hasattr(t, "placements") and t.device.type != "meta"


def refuse_dtensor(t, what: str) -> None:
    """A kernel launches on plain tensors only: a live DTensor's pointer
    is its own object's, not its shard's, so the caller passes the shard
    (``to_local()``) and, for the z kernels, its ``ShardMap``."""
    if live_dtensor(t):
        raise TypeError(
            f"{what}: given a DTensor; pass its local shard (to_local()) "
            "and, for a z write, the shard's ShardMap (shard_map)")


#: elements a launch of a shard route indexes at most (32-bit local index)
SHARD_SPAN = 1 << 31


class ShardMap(NamedTuple):
    """Where a rank's shard of a leaf lies in the whole leaf: the shard
    viewed as (O, Dl, I) inside the global (O, D, I) at row s0, so local
    flat element l = (o, s, i) takes global flat index o·D·I + (s0 + s)·I
    + i.  ``rows`` = Dl·I local elements a row, ``stride`` = D·I global
    elements between rows, ``start`` = s0·I.  The z kernels draw element
    l's z at that index (K1 and K3 its counter mod 2³², X1 its threefry
    counter), so a shard's write is bitwise the slice of the whole leaf's
    (``shard_map`` builds it from a DTensor's placements)."""
    rows: int
    stride: int
    start: int

    def index(self, lo: int, hi: int, device) -> torch.Tensor:
        """Global flat indices (int64) of local elements [lo, hi)."""
        loc = torch.arange(lo, hi, dtype=torch.int64, device=device)
        row = torch.div(loc, self.rows, rounding_mode="floor")
        return self.start + row * self.stride + (loc - row * self.rows)

    def segments(self, n: int, span: int = SHARD_SPAN) -> List[tuple]:
        """The launches over a shard of ``n`` local elements:
        ``(lo, length, rows, stride, start)`` each, ``length`` below
        ``span`` and local element ``lo + j`` at global index
        ``start + (j // rows)·stride + j % rows``: whole rows a launch,
        or pieces of one row where a row is longer than ``span``."""
        R, G = self.rows, self.stride
        out = []
        if n == 0:
            return out
        if R <= span:
            per = span // R * R
            for lo in range(0, n, per):
                out.append((lo, min(per, n - lo), R, G,
                            self.start + lo // R * G))
            return out
        for o in range(n // R):
            for c in range(0, R, span):
                ln = min(span, R - c)
                out.append((o * R + c, ln, ln, ln, self.start + o * G + c))
        return out


def shard_window(shape, dim: int, parts: int, index: int) -> tuple:
    """Shard ``index`` of ``parts`` of a tensor of ``shape`` cut on ``dim``
    by DTensor's ``Shard`` rule (``torch.chunk``'s: ⌈D/parts⌉ rows a shard,
    the last ones short or empty): ``(slices, ShardMap)``, the slices
    selecting the shard in the whole tensor."""
    shape = tuple(shape)
    D = shape[dim]
    per = -(-D // parts)
    lo, hi = min(index * per, D), min((index + 1) * per, D)
    inner = math.prod(shape[dim + 1:])
    sl = tuple(slice(lo, hi) if d == dim else slice(None)
               for d in range(len(shape)))
    return sl, ShardMap((hi - lo) * inner, D * inner, lo * inner)


def share_range(total: int, rank: int, parts: int) -> tuple:
    """Share ``rank`` of ``parts`` of a work list of ``total`` items, cut as
    DTensor's ``Shard`` rule cuts a dim (⌈total/parts⌉ items a share, the
    last ones short or empty): ``(lo, hi)``.  Each share starts at
    ``rank · ⌈total/parts⌉``, so shares padded to that length and gathered
    in rank order hold the list in order in their first ``total`` items."""
    per = -(-total // parts)
    lo = min(rank * per, total)
    return lo, min(lo + per, total)


def shard_map(t) -> Optional[ShardMap]:
    """The ``ShardMap`` of a DTensor's local shard within its global
    tensor (torch's ``compute_local_shape_and_global_offset``), or
    ``None`` where the shard is the whole tensor (replicated).  The
    sharding rules shard one dim a leaf; a shard cut on two dims is not
    one (O, Dl, I) box and raises."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(t.shape)
    local, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    cut = [d for d in range(len(shape))
           if local[d] != shape[d] or offset[d] != 0]
    if not cut:
        return None
    if len(cut) > 1:
        raise NotImplementedError(
            f"a shard of {shape} cut on dims {cut} ({t.placements}): the z "
            "kernels' shard map takes one sharded dim a leaf, as the "
            "sharding rules give (ROADMAP Queue 2)")
    k = cut[0]
    inner = math.prod(shape[k + 1:])
    return ShardMap(local[k] * inner, shape[k] * inner, offset[k] * inner)


def stacked_dtensor(x, local):
    """``local`` — ``n`` streams of DTensor ``x``'s shard stacked on a new
    leading axis, ``(n, *shard.shape)`` — as the DTensor of the global
    ``(n, *x.shape)`` stack: each ``Shard(d)`` of ``x`` moves to
    ``Shard(d + 1)`` (as ``torch.stack`` would place it), ``Replicate``
    stays, and the stride is the stacked tensor's (contiguous)."""
    from torch.distributed.tensor import DTensor, Shard
    shape = torch.Size((local.shape[0],) + tuple(x.shape))
    return DTensor.from_local(
        local, x.device_mesh,
        [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def empty_streams(x, n: int):
    """A shape rule's result for ``n`` streams of ``x``: an empty
    ``(n, *x.shape)`` tensor made by an allocator alone, so a dry run counts
    no traffic for it (the card's route only allocates too).  A DTensor's
    shard dims move one to the right (``stacked_dtensor``)."""
    if not hasattr(x, "placements"):
        return x.new_empty((n,) + tuple(x.shape))
    shard = x.to_local()
    return stacked_dtensor(x, shard.new_empty((n,) + tuple(shard.shape)))


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
    """``t``'s device pointer for a launch; a live DTensor raises (its
    pointer is not its shard's)."""
    refuse_dtensor(t, "a kernel launch")
    return ctypes.c_void_p(t.data_ptr())
