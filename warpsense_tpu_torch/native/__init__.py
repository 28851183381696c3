"""Native (C++) host runtime, built with g++ and loaded with ctypes.

Counterpart of ``warpsense_tpu/native``: ``native.cpp`` is the port's own
copy of the same source (queues, the preprocessing twin and the shift's
slab copies).  It is compiled at first use into
``warpsense_tpu_torch/_build/libnative_<hash>.so``; the hash covers the
source and the flags, so an edited source rebuilds.

A missing compiler, a failed build or a failed load raises.  Callers that
want the numpy twins (``ops/preprocess.preprocess_host``,
``map/local_map.LocalMap``) or the Python queue (``utils/native_queue``)
ask for them by name; nothing switches to them when the build fails.
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

SRC = Path(__file__).with_name("native.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build(src: Path = SRC, build_dir: Path = BUILD_DIR,
          cxx: str | None = None) -> Path:
    """Compile ``src`` into ``build_dir`` (once per source and flags) and
    return the library's path; raises RuntimeError when there is no
    compiler or the compiler fails."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = Path(build_dir) / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    cxx = cxx or shutil.which("g++")
    if cxx is None or not os.access(cxx, os.X_OK):
        raise RuntimeError("g++ not found: the native runtime "
                           f"({src.name}) needs a C++17 compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {src.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders never clash
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ws_version.restype = ctypes.c_int
    lib.ws_ringbuf_create.restype = ctypes.c_void_p
    lib.ws_ringbuf_create.argtypes = [ctypes.c_size_t]
    lib.ws_ringbuf_destroy.restype = None
    lib.ws_ringbuf_destroy.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_size.restype = ctypes.c_size_t
    lib.ws_ringbuf_size.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_clear.restype = None
    lib.ws_ringbuf_clear.argtypes = [ctypes.c_void_p]
    lib.ws_ringbuf_push.restype = ctypes.c_int
    lib.ws_ringbuf_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.c_double]
    lib.ws_ringbuf_pop.restype = ctypes.c_int
    lib.ws_ringbuf_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_double]
    lib.ws_preprocess.restype = ctypes.c_int64
    lib.ws_preprocess.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int64]
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    for fn in (lib.ws_ring_gather, lib.ws_ring_scatter):
        fn.restype = None
        fn.argtypes = [i16p, i16p, i32p, i32p, i32p, i64p, i64p, u32p]
    return lib


def load() -> ctypes.CDLL:
    """The native library, built if needed; raises when it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
