"""Whole-batch assembly primitives: gather windows, pad, augment, mask
(counterpart of ``lam_slide_tpu/data/batch_assembly.py``).

Each primitive has two routes with the same semantics: the port's C++
engine (``lam_slide_tpu_torch/native``, one C call per output array, the
default) and a preallocated-output numpy form, taken only when
``LAM_SLIDE_NO_NATIVE=1``. The numpy forms are the JAX package's, copied,
and are the engine's test oracle: integers agree bit for bit, floats within
1e-5 (the engine sums frame 0's mean in another order). Datasets use these
to implement ``sample_batch``, the whole-batch path the Loader prefers over per-sample
``sample`` + collate (the reference paid this cost with 31 DataLoader worker
processes instead, configs/data/*.yaml).

Semantics pinned by tests against the per-sample path: window gather +
entity padding (reference collate_functions.py:46-82), shift/scale +
rotation + translation augmentation chains (datasets/{md17,nba}.py),
frame-0 centering over real entities (datasets/md17.py:103), exact
attention masks, NBA team flips (datasets/nba.py:97-107).
"""

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from lam_slide_tpu_torch import native

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32pp = ctypes.POINTER(_f32p)
_i64pp = ctypes.POINTER(_i64p)


def _ptr_array(arrs: Sequence[np.ndarray], ptr_type):
    # ctypes reads raw memory: every source MUST be contiguous (strided numpy
    # views — e.g. a downsampled trajectory slice — would silently read the
    # wrong frames). ascontiguousarray is a no-op for well-formed inputs.
    arr_type = ptr_type * len(arrs)
    return arr_type(*(a.ctypes.data_as(ptr_type) for a in arrs))


def _contig(arrs: Sequence[np.ndarray], dtype) -> List[np.ndarray]:
    return [np.ascontiguousarray(a, dtype=dtype) for a in arrs]


def _as_i64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int64)


def source_pointers(arrs: Sequence[np.ndarray], dtype) -> np.ndarray:
    """Precompute a base-pointer table [len(arrs)] (np.uintp) for repeated
    gathers over a fixed source pool (e.g. per-game trajectory buffers).

    The caller must keep ``arrs`` alive and contiguous — datasets own their
    buffers for their lifetime. Per-batch pointer selection then becomes one
    numpy fancy-index instead of thousands of ctypes calls (the 1024-sample
    NBA batch spent ~25 ms building pointer arrays otherwise).
    """
    for a in arrs:
        if not (a.flags.c_contiguous and a.dtype == dtype):
            raise ValueError(f"source_pointers needs contiguous {np.dtype(dtype)} sources")
    return np.fromiter((a.ctypes.data for a in arrs), np.uintp, count=len(arrs))


def _ptrs_arg(src_ptrs: np.ndarray, pp_type):
    src_ptrs = np.ascontiguousarray(src_ptrs, np.uintp)
    return src_ptrs, ctypes.cast(src_ptrs.ctypes.data, pp_type)


def gather_pad_f32(srcs: Optional[List[np.ndarray]], starts, span: int, n_pad: int,
                   src_ptrs: Optional[np.ndarray] = None,
                   n_src=None, c: Optional[int] = None) -> np.ndarray:
    """srcs[b]: [F_b, n_b, c] float32 (contiguous); -> [B, span, n_pad, c].

    Fast form: pass ``src_ptrs`` (per-sample base pointers selected from a
    ``source_pointers`` table) + ``n_src`` + ``c`` and srcs=None: the engine
    route only.
    """
    starts = _as_i64(starts)
    engine = native.available()
    if src_ptrs is None:
        srcs = _contig(srcs, np.float32)
        c = srcs[0].shape[2]
        n_src = [s.shape[1] for s in srcs]
    n_src = _as_i64(n_src)
    b = len(n_src)
    out = np.empty((b, span, n_pad, c), np.float32)
    if engine:
        if src_ptrs is not None:
            _keep, pp = _ptrs_arg(src_ptrs, _f32pp)
        else:
            pp = _ptr_array(srcs, _f32p)
        native.call(
            "gather_pad_f32",
            pp, starts.ctypes.data_as(_i64p), n_src.ctypes.data_as(_i64p),
            span, n_pad, c, b, out.ctypes.data_as(_f32p),
        )
        return out
    if srcs is None:
        raise ValueError("the numpy form needs source arrays, not pointers")
    out.fill(0.0)
    for i, (s, st, n) in enumerate(zip(srcs, starts, n_src)):
        out[i, :, :n] = s[st : st + span]
    return out


def gather_pad_i64(srcs: Optional[List[np.ndarray]], starts, span: int, n_pad: int,
                   src_ptrs: Optional[np.ndarray] = None, n_src=None) -> np.ndarray:
    """srcs[b]: [F_b, n_b] int64; -> [B, span, n_pad]. Fast form as above."""
    starts = _as_i64(starts)
    engine = native.available()
    if src_ptrs is None:
        srcs = _contig(srcs, np.int64)
        n_src = [s.shape[1] for s in srcs]
    n_src = _as_i64(n_src)
    b = len(n_src)
    out = np.empty((b, span, n_pad), np.int64)
    if engine:
        if src_ptrs is not None:
            _keep, pp = _ptrs_arg(src_ptrs, _i64pp)
        else:
            pp = _ptr_array(srcs, _i64p)
        native.call(
            "gather_pad_i64",
            pp, starts.ctypes.data_as(_i64p), n_src.ctypes.data_as(_i64p),
            span, n_pad, b, out.ctypes.data_as(_i64p),
        )
        return out
    if srcs is None:
        raise ValueError("the numpy form needs source arrays, not pointers")
    out.fill(0)
    for i, (s, st, n) in enumerate(zip(srcs, starts, n_src)):
        out[i, :, :n] = s[st : st + span]
    return out


def broadcast_pad_i64(rows: List[np.ndarray], span: int, n_pad: int) -> np.ndarray:
    """rows[b]: [n_b] int64 entity ids; -> [B, span, n_pad] (time-broadcast)."""
    rows = _contig(rows, np.int64)
    b = len(rows)
    n_src = _as_i64([r.shape[0] for r in rows])
    out = np.empty((b, span, n_pad), np.int64)
    if native.available():
        native.call(
            "broadcast_pad_i64",
            _ptr_array(rows, _i64p), n_src.ctypes.data_as(_i64p), span, n_pad, b,
            out.ctypes.data_as(_i64p),
        )
        return out
    out.fill(0)
    for i, (r, n) in enumerate(zip(rows, n_src)):
        out[i, :, :n] = r[None, :]
    return out


def broadcast_pad_rows(rows: np.ndarray, n_real, span: int, n_pad: int) -> np.ndarray:
    """Vectorized broadcast_pad_i64 for a dense [B, n_pad] row matrix whose
    per-sample valid prefix is n_real[b]: zero the padding columns, broadcast
    over time -> [B, span, n_pad]."""
    n_real = _as_i64(n_real)
    valid = np.arange(rows.shape[1])[None, :] < n_real[:, None]
    base = np.where(valid, rows, 0).astype(np.int64)
    return np.broadcast_to(base[:, None, :], (rows.shape[0], span, rows.shape[1])).copy()


def rotate_batch(pos: np.ndarray, rots: Optional[np.ndarray],
                 trans: Optional[np.ndarray] = None,
                 shift: float = 0.0, scale: float = 1.0,
                 n_real=None) -> np.ndarray:
    """In place: pos <- ((pos - shift)/scale) @ R_b^T + t_b on REAL rows only
    (padding stays exactly zero, matching augment-then-pad reference order).

    pos [B, T, N, c] float32 contiguous; rots [B, c, c] or None (identity);
    trans [B, c] or None; n_real [B] real entity counts (default: all).
    """
    b, t, n, c = pos.shape
    n_real = _as_i64([n] * b if n_real is None else n_real)
    if native.available():
        if rots is None:
            rots = np.broadcast_to(np.eye(c, dtype=np.float32), (b, c, c))
        rots = np.ascontiguousarray(rots, np.float32)
        tr = (np.ascontiguousarray(trans, np.float32).ctypes.data_as(_f32p)
              if trans is not None else _f32p())
        native.call(
            "rotate_batch_f32",
            pos.ctypes.data_as(_f32p), rots.ctypes.data_as(_f32p), tr,
            n_real.ctypes.data_as(_i64p),
            np.float32(shift), np.float32(scale), b, t, n, c,
        )
        return pos
    out = (pos - np.float32(shift)) / np.float32(scale)
    if rots is not None:
        out = np.einsum("btnc,bdc->btnd", out, rots.astype(np.float32))
    if trans is not None:
        out = out + trans.astype(np.float32)[:, None, None, :]
    real = np.arange(n)[None, None, :, None] < n_real[:, None, None, None]
    pos[...] = np.where(real, out, 0.0).astype(np.float32)
    return pos


def center_frame0(pos: np.ndarray, n_real) -> np.ndarray:
    """In place: pos_b -= mean over frame 0's first n_real[b] entities."""
    b, t, n, c = pos.shape
    n_real = _as_i64(n_real)
    if native.available():
        native.call("center_frame0_f32", pos.ctypes.data_as(_f32p),
                    n_real.ctypes.data_as(_i64p), b, t, n, c)
        return pos
    for i in range(b):
        pos[i, :, : n_real[i]] -= pos[i, 0, : n_real[i]].mean(axis=0)
    return pos


def attention_mask(n_real, t: int, n_pad: int) -> np.ndarray:
    """[B, t, n_pad] bool: True for real entities."""
    n_real = _as_i64(n_real)
    b = len(n_real)
    if native.available():
        out = np.empty((b, t, n_pad), np.uint8)
        native.call("mask_fill_u8", out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    n_real.ctypes.data_as(_i64p), b, t, n_pad)
        return out.astype(bool)
    mask = np.arange(n_pad)[None, None, :] < n_real[:, None, None]
    return np.broadcast_to(mask, (b, t, n_pad)).copy()


def team_flip(team: np.ndarray, flip) -> np.ndarray:
    """In place: swap labels 1<->2 for samples with flip[b] set.

    team [B, ...] int64 contiguous.
    """
    flip = np.ascontiguousarray(flip, np.uint8)
    b = team.shape[0]
    rows = int(np.prod(team.shape[1:]))
    if native.available():
        native.call("team_flip_i64", team.ctypes.data_as(_i64p),
                    flip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), b, rows)
        return team
    sel = flip.astype(bool)
    sub = team[sel]
    m1, m2 = sub == 1, sub == 2
    sub[m1] = 2
    sub[m2] = 1
    team[sel] = sub
    return team


def permutations_batch(rng: np.random.Generator, b: int, n_pool: int,
                       n_take: int) -> np.ndarray:
    """[B, n_take] random entity-id permutations (vectorized argsort —
    replaces B calls to rng.permutation)."""
    return np.argsort(rng.random((b, n_pool)), axis=1)[:, :n_take].astype(np.int64)
