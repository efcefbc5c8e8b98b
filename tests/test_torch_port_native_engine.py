"""The port's native batch engine (``lam_slide_tpu_torch/native``) against
the JAX package's, and against its own numpy forms, on the CPU.

Both engines compile the same C++ with the same g++ flags, so every entry
point gives the JAX engine's bits, and so do the MD17 and NBA stage-2
loaders on the engine route at one seed. The numpy forms
(``LAM_SLIDE_NO_NATIVE=1``) are the engine's oracle at the limits of the
JAX package's ``tests/test_batch_assembly.py``: integers and masks bit for
bit, floats within 1e-5 (frame 0's mean and the rotation sum in another
order). A failed build raises; nothing falls back.
"""

import functools
import os
import threading

import numpy as np
import pytest

from lam_slide_tpu import native as jnative
from lam_slide_tpu.data import batch_assembly as jba
from lam_slide_tpu.data import collate as jcollate
from lam_slide_tpu.data import loader as jloader
from lam_slide_tpu.data import md17 as jmd17
from lam_slide_tpu.data import nba as jnba
from lam_slide_tpu_torch import native
from lam_slide_tpu_torch.data import batch_assembly as tba
from lam_slide_tpu_torch.data import collate as tcollate
from lam_slide_tpu_torch.data import loader as tloader
from lam_slide_tpu_torch.data import md17 as tmd17
from lam_slide_tpu_torch.data import nba as tnba

FLOAT_TOL = 1e-5  # tests/test_batch_assembly.py:68,79


def _inputs():
    rng = np.random.default_rng(0)
    b, t, n = 3, 5, 6
    srcs3 = [rng.standard_normal((20, k, 3)).astype(np.float32) for k in (4, 6, 5)]
    srcs2 = [rng.standard_normal((20, k, 2)).astype(np.float32) for k in (4, 6, 5)]
    ints = [rng.integers(0, 9, (20, k)).astype(np.int64) for k in (4, 6, 5)]
    pos3 = rng.standard_normal((b, t, n, 3)).astype(np.float32)
    pos2 = rng.standard_normal((b, t, n, 2)).astype(np.float32)
    n_real = np.asarray([4, 6, 5])
    for i, k in enumerate(n_real):  # padding rows are zero, as a gather leaves them
        pos3[i, :, k:] = 0.0
        pos2[i, :, k:] = 0.0
    rots3 = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(b)])
    rots2 = np.stack([np.linalg.qr(rng.standard_normal((2, 2)))[0] for _ in range(b)])
    return dict(
        srcs3=srcs3, srcs2=srcs2, ints=ints, starts=np.asarray([2, 0, 7]),
        rows=[rng.integers(0, 50, k).astype(np.int64) for k in (3, 6, 1)],
        pos3=pos3, pos2=pos2, rots3=rots3.astype(np.float32), rots2=rots2.astype(np.float32),
        trans3=rng.standard_normal((b, 3)).astype(np.float32),
        trans2=rng.standard_normal((b, 2)).astype(np.float32),
        n_real=n_real,
        team=rng.integers(0, 3, (b, t, n)).astype(np.int64), flip=np.asarray([1, 0, 1]),
    )


# name -> fn(batch_assembly module, inputs) on fresh copies of the inputs
PRIMITIVES = {
    "gather_pad_f32": lambda ba, d: ba.gather_pad_f32(d["srcs3"], d["starts"], 8, 7),
    "gather_pad_f32_c2": lambda ba, d: ba.gather_pad_f32(d["srcs2"], d["starts"], 8, 6),
    "gather_pad_i64": lambda ba, d: ba.gather_pad_i64(d["ints"], d["starts"], 8, 7),
    "broadcast_pad_i64": lambda ba, d: ba.broadcast_pad_i64(d["rows"], 4, 7),
    "rotate_batch_3d": lambda ba, d: ba.rotate_batch(d["pos3"], d["rots3"], d["trans3"],
                                                     shift=0.5, scale=2.0,
                                                     n_real=d["n_real"]),
    "rotate_batch_2d": lambda ba, d: ba.rotate_batch(d["pos2"], d["rots2"], d["trans2"],
                                                     shift=47.0, scale=25.0,
                                                     n_real=d["n_real"]),
    "rotate_batch_identity": lambda ba, d: ba.rotate_batch(d["pos3"], None, None,
                                                           scale=3.0),
    "center_frame0": lambda ba, d: ba.center_frame0(d["pos3"], d["n_real"]),
    "attention_mask": lambda ba, d: ba.attention_mask(d["n_real"], 5, 7),
    "team_flip": lambda ba, d: ba.team_flip(d["team"], d["flip"]),
}


@pytest.fixture
def jax_engine():
    assert jnative.available(), "the JAX package's engine did not build"


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_entry_point_matches_jax_engine(name, jax_engine):
    got = PRIMITIVES[name](tba, _inputs())
    want = PRIMITIVES[name](jba, _inputs())
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_engine_matches_numpy_forms(name, monkeypatch):
    calls = native.calls
    got = PRIMITIVES[name](tba, _inputs())
    assert native.calls == calls + 1
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")
    want = PRIMITIVES[name](tba, _inputs())
    assert native.calls == calls + 1  # the numpy forms do not count
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_pointer_tables_match_jax_engine(dtype, jax_engine):
    d = _inputs()
    srcs = d["srcs3"] if dtype == np.float32 else d["ints"]
    n_src = np.asarray([s.shape[1] for s in srcs])
    got = (tba.gather_pad_f32(None, d["starts"], 8, 7, src_ptrs=tba.source_pointers(
               srcs, dtype), n_src=n_src, c=3) if dtype == np.float32 else
           tba.gather_pad_i64(None, d["starts"], 8, 7, src_ptrs=tba.source_pointers(
               srcs, dtype), n_src=n_src))
    want = (jba.gather_pad_f32(srcs, d["starts"], 8, 7) if dtype == np.float32
            else jba.gather_pad_i64(srcs, d["starts"], 8, 7))
    np.testing.assert_array_equal(got, want)


def _datasets(pkg_md17, pkg_nba, kind):
    if kind == "md17":
        return pkg_md17.MD17Dataset(molecule="ethanol", mode="train", first_stage=False,
                                    span=30, num_entities=32, synthetic_frames=3000,
                                    rand_translation=0.1, scale=0.893, shift=0.1)
    return pkg_nba.NBADataset(scene="score", first_stage=False, num_frames=20,
                              synthetic_games=6, shift=47.0, scale=25.0)


def _batches(loader_mod, collate_mod, ds, n=2):
    loader = loader_mod.Loader(ds, 16, functools.partial(collate_mod.pad_collate_temporal,
                                                         num_entities=ds.num_entities), seed=3)
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("kind", ["md17", "nba"])
def test_loaders_on_the_engine_match_jax(kind, jax_engine):
    calls = native.calls
    got = _batches(tloader, tcollate, _datasets(tmd17, tnba, kind))
    assert native.calls > calls
    want = _batches(jloader, jcollate, _datasets(jmd17, jnba, kind))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["md17", "nba"])
def test_loaders_engine_matches_numpy_route(kind, monkeypatch):
    got = _batches(tloader, tcollate, _datasets(tmd17, tnba, kind))
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")
    calls = native.calls
    want = _batches(tloader, tcollate, _datasets(tmd17, tnba, kind))
    assert native.calls == calls
    for g, w in zip(got, want):
        for k in w:
            if w[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_no_native_switch(monkeypatch):
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")
    assert native.lib() is None and not native.available()
    with pytest.raises(RuntimeError, match="LAM_SLIDE_NO_NATIVE"):
        native.call("mask_fill_u8")
    monkeypatch.delenv("LAM_SLIDE_NO_NATIVE")
    assert native.available()


def _fresh_build_dir(monkeypatch, tmp_path, sources=None):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    if sources is not None:
        monkeypatch.setattr(native, "_SOURCES", sources)
    monkeypatch.setattr(native, "_lib", None)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cc"
    broken.write_text('extern "C" void gather_pad_f32() { this is not C++; }\n')
    _fresh_build_dir(monkeypatch, tmp_path, [str(broken)])
    with pytest.raises(RuntimeError, match="native engine build failed") as info:
        native.lib()
    assert "broken.cc" in str(info.value)  # g++'s stderr names the source
    assert not os.path.exists(native.library_path())
    assert os.listdir(native.BUILD_DIR) == []  # no temp file left behind


def test_concurrent_builds_agree(monkeypatch, tmp_path):
    """Concurrent builds each compile to a name of their own and rename
    it into place."""
    _fresh_build_dir(monkeypatch, tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(paths) == 3 and len(set(paths)) == 1
    assert os.listdir(native.BUILD_DIR) == [os.path.basename(paths[0])]
    assert native.lib() is not None and native.lib()._name == paths[0]


def test_builds_only_from_the_port_sources():
    root = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert all(os.path.dirname(p) == os.path.join(root, "native") for p in native._SOURCES)
    assert native.library_path().startswith(os.path.join(root, "_build") + os.sep)
