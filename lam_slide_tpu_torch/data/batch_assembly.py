"""Whole-batch assembly primitives: gather windows, pad, augment, mask.

The numpy forms of ``lam_slide_tpu/data/batch_assembly.py``, copied: the
pieces the whole-batch paths of ``MD17Dataset``, ``PedestrianDataset`` and
``NBADataset`` use. The JAX package also runs them through a C++ engine
(``lam_slide_tpu/native``, with base-pointer tables, ``source_pointers``);
the port's copy of that engine waits for its own slice. Semantics (pinned
there against the per-sample path): window gather + entity padding
(reference collate_functions.py:46-82), shift/scale + rotation +
translation (datasets/{md17,nba}.py), frame-0 centering over real entities
(datasets/md17.py:103), exact attention masks, NBA team flips
(datasets/nba.py:97-107).
"""

from typing import List, Optional

import numpy as np


def _as_i64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int64)


def gather_pad_f32(srcs: List[np.ndarray], starts, span: int, n_pad: int) -> np.ndarray:
    """srcs[b]: [F_b, n_b, c] float32; -> [B, span, n_pad, c], windows
    [starts[b], starts[b] + span) with the entity axis zero-padded."""
    starts = _as_i64(starts)
    srcs = [np.ascontiguousarray(s, dtype=np.float32) for s in srcs]
    out = np.zeros((len(srcs), span, n_pad, srcs[0].shape[2]), np.float32)
    for i, (s, st) in enumerate(zip(srcs, starts)):
        out[i, :, :s.shape[1]] = s[st : st + span]
    return out


def gather_pad_i64(srcs: List[np.ndarray], starts, span: int, n_pad: int) -> np.ndarray:
    """srcs[b]: [F_b, n_b] int64; -> [B, span, n_pad], windows as in
    ``gather_pad_f32``, the entity axis zero-padded."""
    starts = _as_i64(starts)
    out = np.zeros((len(srcs), span, n_pad), np.int64)
    for i, (s, st) in enumerate(zip(srcs, starts)):
        s = np.ascontiguousarray(s, dtype=np.int64)
        out[i, :, :s.shape[1]] = s[st : st + span]
    return out


def broadcast_pad_i64(rows: List[np.ndarray], span: int, n_pad: int) -> np.ndarray:
    """rows[b]: [n_b] int64 entity ids; -> [B, span, n_pad] (time-broadcast)."""
    out = np.zeros((len(rows), span, n_pad), np.int64)
    for i, r in enumerate(rows):
        out[i, :, :len(r)] = np.asarray(r, np.int64)[None, :]
    return out


def broadcast_pad_rows(rows: np.ndarray, n_real, span: int, n_pad: int) -> np.ndarray:
    """A dense [B, n_pad] row matrix whose per-sample valid prefix is
    n_real[b]: zero the padding columns, broadcast over time -> [B, span, n_pad]."""
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
    n_real = _as_i64(n_real)
    for i in range(pos.shape[0]):
        pos[i, :, : n_real[i]] -= pos[i, 0, : n_real[i]].mean(axis=0)
    return pos


def attention_mask(n_real, t: int, n_pad: int) -> np.ndarray:
    """[B, t, n_pad] bool: True for real entities."""
    n_real = _as_i64(n_real)
    mask = np.arange(n_pad)[None, None, :] < n_real[:, None, None]
    return np.broadcast_to(mask, (len(n_real), t, n_pad)).copy()


def team_flip(team: np.ndarray, flip) -> np.ndarray:
    """In place: swap labels 1 <-> 2 for samples with flip[b] set;
    team [B, ...] int64."""
    sel = np.asarray(flip).astype(bool)
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
