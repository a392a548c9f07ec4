"""CUDA C++ sources of the scan kernels, and their loader.

Each library is one ``.cu`` file built with ``nvcc`` for ``sm_90a`` under a
set of defines: the number K of version-rolled chains (``-DVSHARE=K``,
1 ≤ K ≤ 8), for the tile kernel's layouts ``-DVARIANT``, ``-DCGROUP`` and
``-DINTERLEAVE``, and for a compile form ``-DUNROLL`` or ``-DSPEC``
(:func:`form_defines`). The baseline libraries (``scan_tile``,
``scan_tile_k2``, …, ``scan_hitbuf``, …) are known up front
(:data:`SOURCES`); a layout's or a form's library is registered by
:func:`register` when it is first asked for, and the integer throughput
probe's (``int_probe``) when its module is imported. Each builds into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, on first use; the library name carries a digest of
the sources and flags, defines included, so an edited source is rebuilt.
The libraries are bound with ``ctypes``: pointers and the stream pass as
``c_void_p``, and every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception. Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: The most version-rolled chains a kernel is built for.
MAX_VSHARE = 8


def kernel_name(kernel: str, vshare: int) -> str:
    """The name of ``kernel`` built for ``vshare`` chains: its library's
    and its launch counter's (``scan_tile``, ``scan_tile_k2``, ...)."""
    if not 1 <= vshare <= MAX_VSHARE:
        raise ValueError(f"vshare must be in [1, {MAX_VSHARE}], got {vshare}")
    return kernel if vshare == 1 else f"{kernel}_k{vshare}"


#: library name → (source file, defines). Each library is built by one nvcc
#: process with -D<name>=<value> for each define.
SOURCES: Dict[str, Tuple[str, Tuple[Tuple[str, int], ...]]] = {
    **{kernel_name(kernel, k): (source, (("VSHARE", k),))
       for kernel, source in (("scan_tile", "scan_tile.cu"),
                              ("scan_hitbuf", "scan_hitbuf.cu"))
       for k in range(1, MAX_VSHARE + 1)},
}
#: The libraries :func:`build` builds when given no names.
BASELINE = tuple(SOURCES)


def form_defines(unroll: int, spec: bool) -> Dict[str, int]:
    """The defines of a compile form of the scan kernels, the counterpart
    of the JAX kernels' ``unroll`` and ``spec``: none for the default
    (rounds fully unrolled, padding and IV words folded), ``UNROLL`` for a
    rolled round loop (``unroll`` < 64; as in the JAX kernels, spec then
    does not apply), ``SPEC=0`` for the unrolled form without folding."""
    if not isinstance(unroll, int) or unroll < 1:
        raise ValueError(f"unroll must be an int >= 1, got {unroll!r}")
    if unroll < 64:
        return {"UNROLL": unroll}
    return {} if spec else {"SPEC": 0}


def form_suffix(unroll: int, spec: bool) -> str:
    """The library-name suffix of a compile form: ``""``, ``"_u8"``, …,
    ``"_nospec"``."""
    defines = form_defines(unroll, spec)
    if "UNROLL" in defines:
        return f"_u{defines['UNROLL']}"
    return "_nospec" if defines else ""


def register(name: str, source: str, **defines: int) -> str:
    """Add library ``name``: ``source`` built with ``defines``. Returns the
    name; registering a name again with the same spec is a no-op."""
    spec = (source, tuple(defines.items()))
    with _names_lock:
        if SOURCES.setdefault(name, spec) != spec:
            raise ValueError(f"library {name} is already {SOURCES[name]}")
    return name


_P, _I, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_ulonglong)
#: source → C entry point → argtypes, the same for every number of chains;
#: each returns cudaGetLastError() as an int.
ENTRY_POINTS = {
    "scan_tile.cu": {
        # job block (card), job words (host), counts, mins, lowest (or
        # null), the stream's scratch (or null), n_steps, block, word7,
        # stream
        "scan_tile_launch": [_P, _P, _P, _P, _P, _P, _I, _U, _I, _P],
        # word7, threads*, shared bytes*, blocks per SM*
        "scan_tile_occupancy": [_I, _P, _P, _P],
    },
    "scan_hitbuf.cu": {
        # midstates, tail3, limbs, base, limit, blk_hits, blk_counts,
        # ticket, hits, count, lowest (or null), capacity, max_hits, iters,
        # n_blocks, word7, stream
        "scan_hitbuf_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _ULL, _I, _I, _I, _I, _P],
        # job block, k, slots, n_slots, tile, max_hits, iters, blocks per
        # slot, blk_hits, blk_counts, tickets, hits, count, stream
        "rescan_steps_launch": [_P, _I, _P, _I, _U, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P],
    },
    "int_probe.cu": {
        # seed, groups, steps, out, stream; one entry point per ILP
        f"int_probe_ilp{ilp}_launch": [_P, _I, _I, _P, _P]
        for ilp in (1, 2, 4, 8, 16)
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # held while a library builds and loads
_names_lock = threading.Lock()  # SOURCES and the launch counters


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one right after each
    launch it makes, and nowhere else. Thread-safe, since several pump
    threads share one hasher."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._value += 1

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


_counters: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The one :class:`LaunchCounter` named ``name``, made on first use."""
    with _names_lock:
        if name not in _counters:
            _counters[name] = LaunchCounter(name)
        return _counters[name]


def counters() -> Tuple[LaunchCounter, ...]:
    """Every launch counter made so far."""
    with _names_lock:
        return tuple(_counters.values())


def launch_counters(kernel: str) -> Dict[int, LaunchCounter]:
    """One :class:`LaunchCounter` per number of chains ``kernel`` is built
    for, named by :func:`kernel_name`."""
    return {k: launch_counter(kernel_name(kernel, k))
            for k in range(1, MAX_VSHARE + 1)}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}={v}" for d, v in SOURCES[name][1]))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in (SOURCES[name][0], "sha256d.cuh"):
        digest.update((SRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = BASELINE) -> Dict[str, str]:
    """Build the named libraries that are missing, one ``nvcc`` process per
    source, all started together. Returns each library's compiler log
    (``-Xptxas -v``: registers, spills and shared memory per kernel),
    kept beside the library. Raises with the compiler's output on a
    failed build."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *_flags(name), "-o", tmp,
               str(SRC_DIR / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {
        name: (library_path(name).with_suffix(".log").read_text()
               if library_path(name).with_suffix(".log").exists() else "")
        for name in names
    }


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if it is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in ENTRY_POINTS[SOURCES[name][0]].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch entry point reports a CUDA error: a refused
    launch never runs, and a later synchronise would not report it."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def check_tensor(t: torch.Tensor, device: torch.device, dtype: torch.dtype,
                 shape: tuple) -> None:
    """Validate a kernel input: device, type, shape and contiguity."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"kernel inputs must all lie on {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"expected a contiguous {dtype} tensor of shape {shape}, got "
            f"{t.dtype} {tuple(t.shape)}")
