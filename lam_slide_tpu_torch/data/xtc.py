"""GROMACS XTC trajectory IO (native codec, mdtraj-free; counterpart of
``lam_slide_tpu/data/xtc.py``).

The raw 4AA/ATLAS releases ship as ``.xtc``; the reference reads and writes
them through mdtraj (src/utils/traj_utils.py:25-41,106-131). This wraps the
port's xdr3dfcoord codec (lam_slide_tpu_torch/native/xtc.cc):

    positions, meta = read_xtc(path)        # [T, N, 3] float32 (nm)
    write_xtc(path, positions, time=..., box=..., precision=1000.0)

Requires the native engine, built with the host's g++ at first use (a
failed build raises); with ``LAM_SLIDE_NO_NATIVE=1`` XTC IO raises, since the
codec has no numpy form.
"""

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from lam_slide_tpu_torch import native

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _engine():
    if not native.available():
        raise RuntimeError("XTC IO needs the native engine, which LAM_SLIDE_NO_NATIVE=1 "
                           "turns off; unset it, or convert the trajectory to npz/pdb/dcd")


def read_xtc(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """-> (positions [T, N, 3] float32, {"time": [T], "step": [T], "box": [T, 3, 3]})."""
    _engine()
    data = np.fromfile(path, dtype=np.uint8)
    dp = data.ctypes.data_as(_u8p)
    n = native.call("xtc_peek_natoms", dp, len(data), 0)
    if n <= 0:
        raise ValueError(f"{path}: not an XTC file (bad magic)")
    offset = ctypes.c_int64(0)
    step = ctypes.c_int32(0)
    time = ctypes.c_float(0)
    frames, times, steps, boxes = [], [], [], []
    coords = np.empty((n, 3), np.float32)
    box = np.empty((3, 3), np.float32)
    while True:
        got = native.call(
            "xtc_decode_frame",
            dp, len(data), ctypes.byref(offset), ctypes.byref(step),
            ctypes.byref(time), box.ctypes.data_as(_f32p),
            coords.ctypes.data_as(_f32p), n * 3,
        )
        if got == 0:
            break
        if got < 0:
            raise ValueError(f"{path}: corrupt XTC frame at byte {offset.value}")
        frames.append(coords.copy())
        times.append(time.value)
        steps.append(step.value)
        boxes.append(box.copy())
    return np.stack(frames), {
        "time": np.asarray(times, np.float32),
        "step": np.asarray(steps, np.int32),
        "box": np.stack(boxes),
    }


def write_xtc(
    path: str,
    positions: np.ndarray,
    time: Optional[np.ndarray] = None,
    step: Optional[np.ndarray] = None,
    box: Optional[np.ndarray] = None,
    precision: float = 1000.0,
) -> None:
    """positions [T, N, 3] float32 (nm); default 1 ps/frame, unit box."""
    _engine()
    positions = np.ascontiguousarray(positions, np.float32)
    t_len, n, _ = positions.shape
    time = np.arange(t_len, dtype=np.float32) if time is None else np.asarray(time, np.float32)
    step = np.arange(t_len, dtype=np.int32) if step is None else np.asarray(step, np.int32)
    if box is None:
        box = np.broadcast_to(np.eye(3, dtype=np.float32), (t_len, 3, 3))
    box = np.ascontiguousarray(box, np.float32)

    cap = n * 16 + 4096
    buf = np.empty(cap, np.uint8)
    with open(path, "wb") as f:
        for t in range(t_len):
            wrote = native.call(
                "xtc_encode_frame",
                n, int(step[t]), float(time[t]),
                box[t].ctypes.data_as(_f32p),
                positions[t].ctypes.data_as(_f32p),
                float(precision), buf.ctypes.data_as(_u8p), cap,
            )
            if wrote < 0:
                raise RuntimeError(f"XTC encode failed at frame {t}")
            buf[:wrote].tofile(f)
