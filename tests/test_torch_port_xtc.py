"""The port's XTC codec (``lam_slide_tpu_torch/data/xtc.py`` on its own copy
of ``native/xtc.cc``) against the JAX package's, on the CPU.

It decodes the committed golden (``tests/golden/xtc_pyref.xtc``) and the
streams of the independent pure-Python encoder (``support_xtc_pyref.py``)
within the quantization bound, 0.5 / precision, as
``tests/test_xtc_golden.py`` holds JAX; its ``write_xtc`` writes the JAX
package's bytes for the same input and precision; and either package reads
the other's files to the same floats.
"""

import os
import struct

import numpy as np
import pytest

import support_xtc_pyref as pyref
from lam_slide_tpu.data import xtc as jxtc
from lam_slide_tpu_torch import native
from lam_slide_tpu_torch.data import xtc as txtc

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _traj(seed, t, n, spread=2.0, local=0.05):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((t, n, 3)) * spread).astype(np.float32)
    if n > 1:  # water-like pairs exercise the small-diff run encoding
        m = pos[:, 1::2].shape[1]
        pos[:, 1::2] = pos[:, 0::2][:, :m] + local * rng.standard_normal(
            (t, m, 3)).astype(np.float32)
    return pos


def test_committed_golden_artifact():
    expected = np.load(os.path.join(GOLDEN_DIR, "xtc_pyref_expected.npz"))
    dec, meta = txtc.read_xtc(os.path.join(GOLDEN_DIR, "xtc_pyref.xtc"))
    np.testing.assert_allclose(dec, expected["positions"], atol=0.501 / 1000.0, rtol=0)
    np.testing.assert_array_equal(meta["step"], expected["step"])
    np.testing.assert_allclose(meta["time"], expected["time"], rtol=1e-6)
    np.testing.assert_allclose(meta["box"], expected["box"], rtol=1e-6)
    jdec, _ = jxtc.read_xtc(os.path.join(GOLDEN_DIR, "xtc_pyref.xtc"))
    np.testing.assert_array_equal(dec, jdec)


def _regimes():
    rng = np.random.default_rng(2024)
    n = 44  # 4AA-sized system
    base = rng.normal(0, 0.05, (n, 3)).cumsum(axis=0) + 1.5
    return {
        "molecular": base[None] + rng.normal(0, 0.002, (5, n, 3)),
        "dispersed": rng.uniform(-8.0, 8.0, (3, n, 3)),
        "mixed": np.concatenate([rng.normal(0, 0.01, (2, 20, 3)) - 2.0,
                                 rng.uniform(-5, 5, (2, 24, 3))], axis=1),
        "wide": rng.uniform(-9000.0, 9000.0, (2, 12, 3)),
    }


@pytest.mark.parametrize("regime", list(_regimes()))
def test_python_encoder_streams(tmp_path, regime):
    pos = _regimes()[regime].astype(np.float64)
    path = tmp_path / f"{regime}.xtc"
    path.write_bytes(pyref.encode_trajectory(pos, precision=1000.0))
    dec, meta = txtc.read_xtc(str(path))
    assert dec.shape == pos.shape
    # the bound + 2 float32 ulps (at |x| ~ 9000 one ulp is ~0.0005)
    np.testing.assert_allclose(dec, pos, atol=0.501 / 1000.0, rtol=2.4e-7)
    np.testing.assert_array_equal(meta["step"], np.arange(pos.shape[0]))
    np.testing.assert_array_equal(dec, jxtc.read_xtc(str(path))[0])


def test_small_frame_byte_exact(tmp_path):
    """natoms <= 9 frames are raw XDR floats, laid out here with struct."""
    coords = np.array([[0.1, -0.25, 3.5], [1.0, 2.0, -3.0], [0.0, 0.5, 0.125]], np.float32)
    box = np.diag([2.0, 2.5, 3.0]).astype(np.float32)
    raw = struct.pack(">iiif", 1995, 3, 7, 0.002) + struct.pack(">9f", *box.reshape(-1))
    raw += struct.pack(">i", 3) + struct.pack(">9f", *coords.reshape(-1))
    path = tmp_path / "small.xtc"
    path.write_bytes(raw)
    pos, meta = txtc.read_xtc(str(path))
    np.testing.assert_array_equal(pos[0], coords)
    assert meta["step"][0] == 7
    np.testing.assert_array_equal(meta["box"][0], box)


CASES = [(5, 50, 1000.0), (3, 9, 1000.0), (2, 10, 1000.0), (4, 500, 100.0),
         (6, 23, 10000.0), (2, 11, 1000.0)]


@pytest.mark.parametrize("t,n,prec", CASES)
def test_writer_bytes_match_jax_and_round_trip(tmp_path, t, n, prec):
    pos = _traj(n, t, n)
    box = np.tile(np.diag([2.5, 3.0, 3.5]).astype(np.float32), (t, 1, 1))
    time = np.arange(t, dtype=np.float32) * 10.0
    step = np.arange(t, dtype=np.int32) * 500
    kw = dict(time=time, step=step, box=box, precision=prec)
    txtc.write_xtc(str(tmp_path / "t.xtc"), pos, **kw)
    jxtc.write_xtc(str(tmp_path / "j.xtc"), pos, **kw)
    assert (tmp_path / "t.xtc").read_bytes() == (tmp_path / "j.xtc").read_bytes()
    dec, meta = txtc.read_xtc(str(tmp_path / "t.xtc"))
    bound = (0.5 / prec + 1e-6) if n > 9 else 1e-7  # <= 9 atoms: raw floats
    assert np.abs(dec - pos).max() <= bound * 1.5
    np.testing.assert_array_equal(meta["time"], time)
    np.testing.assert_array_equal(meta["step"], step)
    np.testing.assert_array_equal(meta["box"], box)
    np.testing.assert_array_equal(dec, jxtc.read_xtc(str(tmp_path / "t.xtc"))[0])


def test_writer_on_the_spec_grid(tmp_path):
    """The writer's file decodes to the grid the spec quantizes to."""
    pos = np.random.default_rng(5).normal(0, 0.05, (4, 44, 3)).cumsum(axis=1) + 1.0
    txtc.write_xtc(str(tmp_path / "w.xtc"), pos.astype(np.float32), precision=1000.0)
    dec, _ = txtc.read_xtc(str(tmp_path / "w.xtc"))
    expect = np.array([[[pyref._quantize(c, 1000.0) / 1000.0 for c in a] for a in fr]
                       for fr in pos], np.float64)
    np.testing.assert_allclose(dec, expect, atol=1e-6, rtol=0)


def test_corrupt_inputs_raise(tmp_path):
    path = str(tmp_path / "c.xtc")
    txtc.write_xtc(path, _traj(1, 2, 30))
    raw = np.fromfile(path, np.uint8)
    assert int.from_bytes(raw[:4].tobytes(), "big") == 1995
    (tmp_path / "bad.xtc").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        txtc.read_xtc(str(tmp_path / "bad.xtc"))
    raw[: len(raw) // 2].tofile(str(tmp_path / "trunc.xtc"))
    with pytest.raises(ValueError, match="corrupt"):
        txtc.read_xtc(str(tmp_path / "trunc.xtc"))


def test_codec_counts_its_calls_and_needs_the_engine(tmp_path, monkeypatch):
    calls = native.calls
    txtc.write_xtc(str(tmp_path / "a.xtc"), _traj(2, 3, 12))
    assert native.calls == calls + 3  # one encode a frame
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="LAM_SLIDE_NO_NATIVE"):
        txtc.read_xtc(str(tmp_path / "a.xtc"))
