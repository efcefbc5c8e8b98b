"""Build and load the port's CUDA kernels (no JAX counterpart).

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a``, one process
per source started together, and link into one shared library with a plain
C interface, loaded with ``ctypes``. The build lives in
``lam_slide_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so it reruns only when they change. A failed build raises; nothing
falls back.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``launch`` raises when that
is non-zero.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "liblam_slide_kernels.so"

# C signatures of the entry points (pointer and stream arguments are void*
# so ctypes passes all 64 bits).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_FLASH_FWD = [_P] * 6 + [_I] * 5 + [_L] * 12 + [_F, _P]
_FLASH_BWD = [_P] * 10 + [_I] * 5 + [_LP, _F, _P]
SIGNATURES = {
    "lam_flash_attention_fwd": _FLASH_FWD,
    "lam_flash_attention_fwd_f32": [_P] * 6 + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P],
    "lam_flash_attention_fwd_sm90": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _P],
    "lam_flash_attention_bwd_sm90": [_P] * 10 + [_I] * 5 + [_LP, _F, _I, _P],
    "lam_qk_normrope": [_P] * 8 + [_I] * 5 + [_L] * 6 + [_F, _P],
    "lam_qk_normrope_f32": [_P] * 8 + [_I] * 5 + [_L] * 6 + [_F, _P],
    "lam_flash_attention_bwd_kv": _FLASH_BWD,
    "lam_flash_attention_bwd_q": _FLASH_BWD,
    "lam_flash_attention_bwd_f32": [_P] * 11 + [_I] * 5 + [_LP, _F, _I, _P],
    "lam_fused_mlp_sm90": [_P] * 6 + [_I] * 4 + [_L] * 4 + [_I] * 4 + [_P],
    "lam_fused_mlp_wmma": [_P] * 5 + [_I] * 4 + [_L] * 4 + [_P],
    "lam_fused_mlp_f32": [_P] * 5 + [_I] * 4 + [_L] * 4 + [_I, _I, _P],
    "lam_fused_mlp_f32_tiled": [_P] * 5 + [_I] * 4 + [_L] * 2 + [_I, _P],
    "lam_adaln_fwd": [_P] * 7 + [_LP, _F, _I, _P],
    "lam_adaln_fwd_f32": [_P] * 7 + [_LP, _F, _I, _P],
    "lam_spatial_block_wmma": [_P] * 10 + [_L, _I, _I, _I, _I, _L, _L, _F, _P],
    "lam_spatial_block_sm90": [_P] * 11 + [_L, _I, _I, _I, _I, _L, _L, _F, _I, _I, _I, _I, _P],
    "lam_spatial_block_f32": [_P] * 10 + [_L, _I, _I, _I, _I, _L, _L, _F, _I, _P],
    "lam_spatial_block_f32_tiled": [_P] * 10 + [_L, _I, _I, _I, _I, _F, _I, _I, _P],
    "lam_short_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 8 + [_F, _P],
    "lam_short_attention_fwd_f32": [_P] * 4 + [_I] * 6 + [_L] * 8 + [_F, _P],
    "lam_short_attention_bwd": [_P] * 7 + [_I] * 5 + [_LP, _L, _L, _F, _P],
    "lam_short_attention_bwd_f32": [_P] * 7 + [_I] * 6 + [_LP, _L, _L, _F, _P],
    "lam_fused_temporal_fwd": [_P] * 8 + [_I] * 4 + [_L] * 12 + [_F, _F, _P],
    "lam_short_backward": [_P] * 10 + [_I] * 5 + [_LP, _F, _I, _P],
    "lam_short_backward_f32": [_P] * 9 + [_I] * 5 + [_LP, _F, _P],
}


def sources() -> list:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _finish(cmd: list, output: str, returncode: int, verbose: bool) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")
    if verbose and output:
        print(output)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed build directory; return the .so path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), f"-I{CSRC}", "-c",
               "-o", str(out_dir / f"{src.stem}.{os.getpid()}.o"), str(src)]
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    done = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in compiles]
    for cmd, output, returncode in done:
        _finish(cmd, output, returncode, verbose)
    objects = [cmd[-2] for cmd, _, _ in done]
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objects]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _finish(cmd, proc.stdout + proc.stderr, proc.returncode, verbose)
    for obj in objects:
        os.remove(obj)
    os.replace(tmp, lib)
    (out_dir / "build_seconds.txt").write_text(f"{time.perf_counter() - t0:.3f}\n")
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lam_error_string.argtypes = [ctypes.c_int]
    lib.lam_error_string.restype = ctypes.c_char_p
    lib.lam_flash_attention_bwd_sm90_scratch.argtypes = [_I] * 4
    lib.lam_flash_attention_bwd_sm90_scratch.restype = _L
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if it reports a CUDA error."""
    lib = load_library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.lam_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
