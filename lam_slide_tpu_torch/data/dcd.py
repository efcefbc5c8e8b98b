"""CHARMM/NAMD DCD trajectory codec (pure numpy, host-side), copied from
``lam_slide_tpu/data/dcd.py``.

Completes the multi-format trajectory surface of the reference's
``load_traj`` (src/utils/traj_utils.py:25-41), which accepts ``.dcd``
through mdtraj. DCD is a sequence of Fortran unformatted records (each
payload wrapped in int32 byte-length markers):

    header  'CORD' + 20 int32 control words (icntrl); icntrl[0] = nframes,
            icntrl[10] = unit-cell flag, icntrl[19] = CHARMM version
    titles  int32 count + count x 80-byte lines
    natoms  one int32
    frames  [48-byte unit cell (6 float64) if icntrl[10]] + X, Y, Z
            records (each natoms float32)

Coordinates are stored in Angstrom; ``read_dcd`` returns nanometers to
match the xtc path (mdtraj applies the same conversion). Both little- and
big-endian files are handled (detected from the header record marker).
"""

import struct

import numpy as np

_HDR = b"CORD"


def _marker(f, fmt):
    raw = f.read(4)
    if len(raw) < 4:
        raise EOFError
    return struct.unpack(fmt + "i", raw)[0]


def _record(f, fmt):
    n = _marker(f, fmt)
    if not 0 <= n < (1 << 31):
        raise ValueError(f"bad record length {n}")
    payload = f.read(n)
    if len(payload) < n:
        raise ValueError("truncated record")
    if _marker(f, fmt) != n:
        raise ValueError("record length markers disagree")
    return payload


def read_dcd(path):
    """-> (xyz [T, natoms, 3] float32 in nm, unit_cells [T, 6] or None)."""
    with open(path, "rb") as f:
        first = f.read(4)
        if len(first) < 4:
            raise ValueError("not a DCD file: too short")
        (n,) = struct.unpack("<i", first)
        fmt = "<" if n == 84 else ">"
        if fmt == ">" and struct.unpack(">i", first)[0] != 84:
            raise ValueError("not a DCD file: header record is not 84 bytes")
        f.seek(0)
        header = _record(f, fmt)
        if header[:4] != _HDR:
            raise ValueError("not a DCD file: missing CORD magic")
        icntrl = np.frombuffer(header[4:84], dtype=np.dtype(fmt + "i4"))
        # icntrl[10] is the crystal flag only in CHARMM-flavor files
        # (icntrl[19] = version != 0); in X-PLOR files that word overlaps a
        # float64 AKMA timestep and holds arbitrary bits — mdtraj likewise
        # honors the flag only when the version tag is set.
        has_cell = bool(icntrl[10]) and int(icntrl[19]) != 0
        _record(f, fmt)  # titles — ignored
        (natoms,) = struct.unpack(fmt + "i", _record(f, fmt))
        if natoms <= 0:
            raise ValueError(f"bad natoms {natoms}")

        frames, cells = [], []
        while True:
            try:
                cell = None
                if has_cell:
                    raw = _record(f, fmt)
                    if len(raw) != 48:
                        raise ValueError("bad unit-cell record")
                    cell = np.frombuffer(raw, dtype=np.dtype(fmt + "f8"))
                axes = []
                for _ in range(3):
                    rec = _record(f, fmt)
                    if len(rec) != 4 * natoms:
                        raise ValueError("coordinate record size mismatch")
                    axes.append(np.frombuffer(rec, dtype=np.dtype(fmt + "f4")))
            except EOFError:
                # A file cut between a frame's cell record and its X/Y/Z
                # records drops the orphaned cell with the partial frame —
                # cells and frames stay index-matched.
                break
            frames.append(np.stack(axes, axis=1))
            if cell is not None:
                cells.append(cell)
    if not frames:
        raise ValueError("DCD contains no frames")
    xyz = np.asarray(np.stack(frames), np.float32) * 0.1  # Angstrom -> nm
    return xyz, (np.stack(cells).astype(np.float64) if cells else None)


def write_dcd(path, xyz_nm, unit_cells=None):
    """xyz_nm [T, natoms, 3] in nm -> minimal CHARMM-flavor DCD (Angstrom)."""
    xyz = np.asarray(xyz_nm, np.float32) * 10.0  # nm -> Angstrom
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be [T, natoms, 3], got {xyz.shape}")
    nframes, natoms, _ = xyz.shape

    def rec(payload):
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    icntrl = np.zeros(20, np.int32)
    icntrl[0] = nframes
    icntrl[1] = 1  # first step
    icntrl[2] = 1  # step interval
    icntrl[3] = nframes
    icntrl[10] = 1 if unit_cells is not None else 0
    icntrl[19] = 24  # CHARMM version tag
    title = b"REMARKS written by lam_slide_tpu_torch.data.dcd".ljust(80)[:80]
    with open(path, "wb") as f:
        f.write(rec(_HDR + icntrl.tobytes()))
        f.write(rec(struct.pack("<i", 1) + title))
        f.write(rec(struct.pack("<i", natoms)))
        for t in range(nframes):
            if unit_cells is not None:
                f.write(rec(np.asarray(unit_cells[t], np.float64).tobytes()))
            for ax in range(3):
                f.write(rec(np.ascontiguousarray(xyz[t, :, ax]).tobytes()))
