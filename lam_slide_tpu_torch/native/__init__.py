"""Host-side batch engine and XTC codec in C++, through ctypes (counterpart
of ``lam_slide_tpu/native``, with its own copies of ``batch_engine.cc`` and
``xtc.cc`` beside this file).

``lib()`` returns the loaded shared library. It is built with g++ at first
use into ``lam_slide_tpu_torch/_build/``, keyed by a hash of the sources and
flags, so it rebuilds only when they change; each process compiles to a
name of its own and renames it into place, so concurrent processes (test
workers, a benchmark) may race the build safely. A failed build raises with
g++'s stderr: nothing falls back to numpy quietly. ``LAM_SLIDE_NO_NATIVE=1``
(read at every call) is the one way to ask for the numpy forms, and then
``lib()`` returns None.

``calls`` counts the calls into the engine (``call``), as the kernels'
counters count their launches.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_HERE, "batch_engine.cc"), os.path.join(_HERE, "xtc.cc")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls = 0  # calls into the engine, through ``call``

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_f32 = ctypes.c_float
_f32p = ctypes.POINTER(_f32)
_i64p = ctypes.POINTER(_i64)
_i32p = ctypes.POINTER(_i32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32pp = ctypes.POINTER(_f32p)
_i64pp = ctypes.POINTER(_i64p)

# name -> (return type, argument types)
SIGNATURES = {
    "gather_pad_f32": (None, [_f32pp, _i64p, _i64p, _i64, _i64, _i64, _i64, _f32p]),
    "gather_pad_i64": (None, [_i64pp, _i64p, _i64p, _i64, _i64, _i64, _i64p]),
    "broadcast_pad_i64": (None, [_i64pp, _i64p, _i64, _i64, _i64, _i64p]),
    "rotate_batch_f32": (None, [_f32p, _f32p, _f32p, _i64p, _f32, _f32, _i64, _i64, _i64,
                                _i64]),
    "center_frame0_f32": (None, [_f32p, _i64p, _i64, _i64, _i64, _i64]),
    "mask_fill_u8": (None, [_u8p, _i64p, _i64, _i64, _i64]),
    "team_flip_i64": (None, [_i64p, _u8p, _i64, _i64]),
    # the GROMACS XTC codec (xtc.cc)
    "xtc_decode_frame": (_i32, [_u8p, _i64, _i64p, _i32p, _f32p, _f32p, _f32p, _i64]),
    "xtc_peek_natoms": (_i32, [_u8p, _i64, _i64]),
    "xtc_encode_frame": (_i64, [_i32, _i32, _f32, _f32p, _f32p, _f32, _u8p, _i64]),
}


def library_path() -> str:
    """Where this hash of the sources and flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"engine_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the engine unless this hash of it exists; -> the library's
    path. Raises RuntimeError with g++'s stderr when the build fails."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp_path, *_SOURCES]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native engine build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native engine build failed (g++ exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp_path, so_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return so_path


def lib() -> Optional[ctypes.CDLL]:
    """The loaded engine, built at first use; None only when
    ``LAM_SLIDE_NO_NATIVE=1``."""
    global _lib
    if os.environ.get("LAM_SLIDE_NO_NATIVE") == "1":
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                cdll = ctypes.CDLL(build())
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(cdll, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = cdll
    return _lib


def available() -> bool:
    """True unless ``LAM_SLIDE_NO_NATIVE=1``; builds the engine on the way
    (and raises if that fails)."""
    return lib() is not None


def call(name: str, *args):
    """Call the engine's ``name`` and count it."""
    global calls
    eng = lib()
    if eng is None:
        raise RuntimeError(f"native.call({name!r}) with LAM_SLIDE_NO_NATIVE=1")
    calls += 1
    return getattr(eng, name)(*args)
