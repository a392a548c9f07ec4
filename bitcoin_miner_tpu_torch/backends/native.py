"""ctypes loader of the native CPU hasher (``native/sha256d.cpp``).

Counterpart of ``bitcoin_miner_tpu/backends/native.py``, over the
package's own copy of the C++ source. It is host code: it hashes on the
CPU, for ``--backend native`` and the pool frontend's share validator.

The library is built with ``g++`` directly (no ``make``) into
``build/native/`` at the root of the checkout, on first use: one
compile-probe of the SHA-NI constructs the source uses (a toolchain that
rejects them builds the scalar path with ``-DBTM_NO_SHANI``), then one
compile to a temporary file renamed into place, so a process that loads
the library concurrently never sees it half written. The file name
carries a digest of the source and the flags, so an edited source is
rebuilt. A failed build raises ``OSError`` with the compiler's output;
nothing builds at import time.
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
from typing import Optional, Tuple

SRC_PATH = Path(__file__).resolve().parents[1] / "native" / "sha256d.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: Baseline x86-64 flags, never -march=native: the SHA instructions exist
#: only in legacy encoding, and wide-vector code around them is ~80x slower
#: on AVX-512 CPUs (the source refuses AVX2/AVX-512 codegen). The SHA-NI
#: functions opt into their ISA per function, behind a CPUID dispatch.
CXX_FLAGS = ("-O3", "-funroll-loops", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

#: The constructs of the source's SHA-NI path: the intrinsics under the
#: "sha" target attribute and the raw CPUID read of the dispatch.
_SHANI_PROBE = """
#include <immintrin.h>
#include <cpuid.h>
__attribute__((target("sha,sse4.1,ssse3")))
void probe(unsigned* s) {
  __m128i a = _mm_loadu_si128((const __m128i*)s);
  a = _mm_sha256rnds2_epu32(a, a, a);
  a = _mm_sha256msg1_epu32(a, a);
  _mm_storeu_si128((__m128i*)s, a);
}
int pick(void) {
  unsigned a, b, c, d;
  return __get_cpuid_count(7, 0, &a, &b, &c, &d) ? (int)(b >> 29) & 1 : 0;
}
"""

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None
_lock = threading.Lock()


def compiler() -> str:
    """``g++`` on the PATH."""
    cxx = shutil.which("g++")
    if not cxx:
        raise OSError("native hasher unavailable: no C++ compiler (g++)")
    return cxx


def shani_supported(cxx: str) -> bool:
    """Whether ``cxx`` compiles the source's SHA-NI constructs."""
    proc = subprocess.run(
        [cxx, "-x", "c++", "-c", "-o", os.devnull, "-"],
        input=_SHANI_PROBE, capture_output=True, text=True)
    return proc.returncode == 0


def build_flags(cxx: str) -> Tuple[str, ...]:
    """The flags the library builds with under ``cxx``."""
    return CXX_FLAGS if shani_supported(cxx) else (*CXX_FLAGS,
                                                   "-DBTM_NO_SHANI")


def library_path(flags: Tuple[str, ...], build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(SRC_PATH.read_bytes())
    return build_dir / f"libsha256d-{digest.hexdigest()[:12]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Build the library under ``build_dir`` unless it is there; returns
    its path. Raises ``OSError`` with the compiler's output on a failed
    build."""
    cxx = compiler()
    flags = build_flags(cxx)
    out = library_path(flags, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    proc = subprocess.run([cxx, *flags, "-o", tmp, str(SRC_PATH)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise OSError(f"native hasher unavailable: {cxx} failed:\n"
                      f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built first if it is missing. A failure is
    remembered: later calls raise the same ``OSError`` without building
    again."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise OSError(_load_error)
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            _load_error = str(e)
            raise
        P = ctypes.POINTER
        lib.btm_sha256d.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    P(ctypes.c_uint8)]
        lib.btm_sha256d.restype = None
        lib.btm_midstate.argtypes = [ctypes.c_char_p, P(ctypes.c_uint32)]
        lib.btm_midstate.restype = None
        lib.btm_scan.argtypes = [
            ctypes.c_char_p,     # header76
            ctypes.c_uint32,     # nonce_start
            ctypes.c_uint64,     # count
            ctypes.c_char_p,     # target32 (big-endian bytes)
            P(ctypes.c_uint32),  # hit nonces out
            ctypes.c_uint32,     # max_hits
        ]
        lib.btm_scan.restype = ctypes.c_uint64
        lib.btm_backend.argtypes = []
        lib.btm_backend.restype = ctypes.c_char_p
        lib.btm_sha256_blocks.argtypes = [
            P(ctypes.c_uint32),  # state (read-write)
            ctypes.c_char_p,     # whole 64-byte blocks
            ctypes.c_uint32,     # nblocks
        ]
        lib.btm_sha256_blocks.restype = None
        lib.btm_validate_share.argtypes = [
            P(ctypes.c_uint32),  # mid8 (NULL: the IV)
            ctypes.c_uint64,     # bytes absorbed into mid8
            ctypes.c_char_p,     # coinbase tail
            ctypes.c_size_t,     # tail length
            ctypes.c_char_p,     # merkle branch blob (n × 32 bytes)
            ctypes.c_uint32,     # branch length n
            ctypes.c_char_p,     # header prefix36
            ctypes.c_uint32,     # ntime
            ctypes.c_uint32,     # nbits
            ctypes.c_uint32,     # nonce
            ctypes.c_char_p,     # target32 (big-endian bytes)
            P(ctypes.c_uint8),   # digest out (32 bytes)
        ]
        lib.btm_validate_share.restype = ctypes.c_int
        _lib = lib
        return lib


def backend_name() -> str:
    """The compression path CPUID picked: ``shani`` or ``scalar``."""
    return load().btm_backend().decode()


def native_available() -> bool:
    try:
        load()
        return True
    except OSError:
        return False


def sha256d(data: bytes) -> bytes:
    lib = load()
    out = (ctypes.c_uint8 * 32)()
    lib.btm_sha256d(data, len(data), out)
    return bytes(out)


def midstate(first64: bytes) -> Tuple[int, ...]:
    if len(first64) != 64:
        raise ValueError("midstate needs 64 bytes")
    lib = load()
    out = (ctypes.c_uint32 * 8)()
    lib.btm_midstate(first64, out)
    return tuple(out)


def scan(header76: bytes, nonce_start: int, count: int, target: int,
         max_hits: int) -> Tuple[list, int]:
    """``(hit nonces[:max_hits], total hits)`` over ``[nonce_start,
    nonce_start + count)``."""
    lib = load()
    hits = (ctypes.c_uint32 * max_hits)()
    total = lib.btm_scan(header76, nonce_start, count,
                         target.to_bytes(32, "big"), hits, max_hits)
    return list(hits[: min(total, max_hits)]), int(total)


def prefix_midstate(prefix: bytes) -> Tuple["ctypes.Array", int, bytes]:
    """``(mid8, absorbed, remainder)`` of a coinbase prefix, for
    :func:`validate_share`: the SHA-256 state after the prefix's whole
    64-byte blocks (the IV when it is shorter than one block, with
    ``absorbed`` 0), the bytes folded in, and the sub-block remainder
    that each submit's tail is prepended with."""
    lib = load()
    mid8 = (ctypes.c_uint32 * 8)(
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    )
    absorbed = len(prefix) - len(prefix) % 64
    if absorbed:
        lib.btm_sha256_blocks(mid8, prefix[:absorbed], absorbed // 64)
    return mid8, absorbed, prefix[absorbed:]


def validator_handles() -> Tuple[object, "ctypes.Array"]:
    """``(btm_validate_share, digest buffer)`` for the frontend's submit
    path, which calls the function directly with one reusable buffer (the
    event loop is one thread, and each digest is read before the next
    call) instead of paying :func:`validate_share`'s lookups and
    allocation per submit."""
    lib = load()
    return lib.btm_validate_share, (ctypes.c_uint8 * 32)()


def validate_share(mid8: "ctypes.Array", absorbed: int, tail: bytes,
                   branch_blob: bytes, branch_n: int, prefix36: bytes,
                   ntime: int, nbits: int, nonce: int,
                   target32: bytes) -> Tuple[bool, bytes]:
    """One share in one call: the coinbase finished from its prefix
    midstate, the merkle fold, the header's sha256d and the target
    compare. Returns ``(meets the target, header digest)``, the digest in
    sha256d's natural order."""
    lib = load()
    digest = (ctypes.c_uint8 * 32)()
    ok = lib.btm_validate_share(mid8, absorbed, tail, len(tail), branch_blob,
                                branch_n, prefix36, ntime, nbits, nonce,
                                target32, digest)
    return bool(ok), bytes(digest)
