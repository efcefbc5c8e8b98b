"""The pedestrian (ETH/UCY) and NBA workloads of the port against the JAX
package, on the CPU: the modules up to stage 1 and the registries.

* ``ops/kmeans.py``: ``kmeans`` / ``batched_kmeans`` against JAX's on
  separated clusters, on random sets of K=60 final positions in 20
  clusters (the NBA FPC shape) and on sets with duplicate points, where
  clusters stay empty and keep their centres: centres within 1e-6,
  assignments equal.
* ``composites/evaluation.py``: ``per_entity_min_k_ade_fde`` with FPC off
  and on, ``min_over_k_ade_fde`` and ``assert_no_target_leak``, within 1e-6.
* ``data/augment.py``, ``data/batch_assembly.py``, ``data/pedestrian.py``
  and ``data/nba.py``: numpy on both sides, so equal bit for bit at the same
  seed (the JAX native batch engine off): the 2D augmentations, the gathers,
  the team flip, ``sample`` and the whole-batch ``sample_batch`` with the
  rotations, flips and translations, the npy / npz loaders with NBA's
  filename-hash holdout.
* The first stages (``composites/pedestrian.py``, ``composites/nba.py``):
  forward and loss on weights carried over by ``convert.py``, within 1e-5;
  NBA's ``classification_metrics`` exactly.

The four registry experiments are held to JAX's in
``tests/test_torch_port_pedestrian_nba_registry.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu import native
from lam_slide_tpu.composites import evaluation as jeval
from lam_slide_tpu.composites import nba as jnba_c
from lam_slide_tpu.composites import pedestrian as jped_c
from lam_slide_tpu.data import augment as jaug
from lam_slide_tpu.data import batch_assembly as jba
from lam_slide_tpu.data import nba as jnba
from lam_slide_tpu.data import pedestrian as jped
from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu.ops import kmeans as jkm
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import evaluation as teval
from lam_slide_tpu_torch.composites import nba as tnba_c
from lam_slide_tpu_torch.composites import pedestrian as tped_c
from lam_slide_tpu_torch.data import augment as taug
from lam_slide_tpu_torch.data import batch_assembly as tba
from lam_slide_tpu_torch.data import nba as tnba
from lam_slide_tpu_torch.data import pedestrian as tped
from lam_slide_tpu_torch.ops import kmeans as tkm

# fp32 on both sides: sums of a few terms in another order
KMEANS_TOL = 1e-6
EVAL_TOL = 1e-6
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def numpy_batch_assembly(monkeypatch):
    """The JAX package's numpy forms of the batch-assembly primitives, which
    the port copies (its C++ engine sums in another order)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")  # the port's numpy forms too


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0), name


# ---------------------------------------------------------------- k-means

def _blobs(rng, b, per, centres, spread=0.05):
    pts = np.concatenate([c + spread * rng.standard_normal((b, per, 2)) for c in centres], 1)
    return pts[:, rng.permutation(pts.shape[1])].astype(np.float32)


def _kmeans_cases():
    rng = np.random.default_rng(0)
    dup = np.repeat(rng.standard_normal((2, 3, 2)), 2, axis=1).astype(np.float32)
    return {
        "separated": (_blobs(rng, 3, 10, [(-4, 0), (4, 0), (0, 4), (0, -4)]), 4),
        "fpc": (rng.standard_normal((5, 60, 2)).astype(np.float32), 20),
        "duplicates": (dup, 5),  # 3 distinct points a set, 5 clusters: two stay empty
    }


@pytest.mark.parametrize("case", sorted(_kmeans_cases()))
def test_batched_kmeans_matches_jax(case):
    """Farthest-point init, 20 Lloyd iterations with the guarded mean: the
    port's centres within KMEANS_TOL of JAX's and the assignments equal."""
    points, c = _kmeans_cases()[case]
    wc, wa = jkm.batched_kmeans(jnp.asarray(points), c)
    gc, ga = tkm.batched_kmeans(torch.from_numpy(points), c)
    _close(gc, wc, KMEANS_TOL, "centres")
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    if case == "duplicates":  # empty clusters kept their centres
        counts = np.stack([np.bincount(a, minlength=c) for a in ga.numpy()])
        assert (counts == 0).any()
    if case == "separated":  # each blob is one cluster
        for a in ga.numpy():
            assert len(set(a.tolist())) == 4


@pytest.mark.parametrize("n_iters", [0, 1, 20])
def test_single_set_kmeans_matches_jax(n_iters):
    points = np.random.default_rng(1).standard_normal((40, 2)).astype(np.float32)
    wc, wa = jkm.kmeans(jnp.asarray(points), 6, n_iters)
    gc, ga = tkm.kmeans(torch.from_numpy(points), 6, n_iters)
    _close(gc, wc, KMEANS_TOL)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


# ---------------------------------------------------------------- evaluation

def _pred_true_mask(seed, k=6, b=3, tp=5, n=4):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((k, b, tp, n, 2)).astype(np.float32)
    true = rng.standard_normal((b, tp, n, 2)).astype(np.float32)
    pred[2, 0, :, 1] = true[0, :, 1]  # a zero error: safe_norm's branch
    mask = rng.random((b, n)) > 0.3
    mask[:, 0] = True
    return pred, true, mask


@pytest.mark.parametrize("fpc,num_runs", [(False, None), (False, 3), (True, 3), (True, 6)])
def test_per_entity_min_k_matches_jax(fpc, num_runs):
    pred, true, mask = _pred_true_mask(2)
    want = jeval.per_entity_min_k_ade_fde(jnp.asarray(pred), jnp.asarray(true),
                                          jnp.asarray(mask), num_runs=num_runs, fpc=fpc)
    got = teval.per_entity_min_k_ade_fde(torch.from_numpy(pred), torch.from_numpy(true),
                                         torch.from_numpy(mask), num_runs=num_runs, fpc=fpc)
    for g, w in zip(got, want):
        assert g.dim() == 0
        _close(g, w, EVAL_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_min_over_k_matches_jax(masked):
    pred, true, _ = _pred_true_mask(3)
    mask = np.random.default_rng(4).random(true.shape[:3]) > 0.2 if masked else None
    want = jeval.min_over_k_ade_fde(jnp.asarray(pred), jnp.asarray(true),
                                    None if mask is None else jnp.asarray(mask))
    got = teval.min_over_k_ade_fde(torch.from_numpy(pred), torch.from_numpy(true),
                                   None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w, EVAL_TOL)


@pytest.mark.parametrize("leak", [False, True])
def test_assert_no_target_leak_matches_jax(leak):
    """Target frames zeroed pass; one nonzero target value raises, with
    JAX's message."""
    pos = np.random.default_rng(5).standard_normal((2, 6, 3, 2)).astype(np.float32)
    pos[:, 4:] = 0
    if leak:
        pos[1, 5, 2, 0] = 1e-3
    outcomes = []
    for fn, arr in ((jeval.assert_no_target_leak, jnp.asarray(pos)),
                    (teval.assert_no_target_leak, torch.from_numpy(pos))):
        try:
            fn({"pos": arr}, 4, keys=("pos", "atom"))
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == leak


# ---------------------------------------------------------------- data

def test_2d_augmentations_match_jax():
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(taug.random_rotation_matrix_2d(r1),
                                      jaug.random_rotation_matrix_2d(r2))
    rng = np.random.default_rng(9)
    pts, rot = rng.standard_normal((4, 7, 2)), jaug.random_rotation_matrix_2d(rng)
    for p in (pts, pts[0]):
        np.testing.assert_array_equal(taug.rotate_about_center(p, rot),
                                      jaug.rotate_about_center(p, rot))
    np.testing.assert_array_equal(taug.scale_to_new_range(pts), jaug.scale_to_new_range(pts))
    np.testing.assert_array_equal(taug.scale_to_new_range(pts, -2, 2, 0, 1),
                                  jaug.scale_to_new_range(pts, -2, 2, 0, 1))


def test_batch_assembly_numpy_forms_match_jax():
    rng = np.random.default_rng(10)
    srcs = [rng.integers(0, 9, size=(rng.integers(8, 12), n)).astype(np.int64)
            for n in (3, 5, 7)]
    starts = [0, 2, 1]
    np.testing.assert_array_equal(tba.gather_pad_i64(srcs, starts, 6, 8),
                                  jba.gather_pad_i64(srcs, starts, 6, 8))
    rows = [rng.integers(0, 9, size=n).astype(np.int64) for n in (2, 5, 4)]
    np.testing.assert_array_equal(tba.broadcast_pad_i64(rows, 3, 6),
                                  jba.broadcast_pad_i64(rows, 3, 6))
    team = rng.integers(0, 3, size=(5, 4, 11)).astype(np.int64)
    flip = rng.random(5) < 0.5
    np.testing.assert_array_equal(tba.team_flip(team.copy(), flip),
                                  jba.team_flip(team.copy(), flip))


PED_AUG = dict(rand_rotation=True, flip_vertical=True, flip_horizontal=True,
               rand_translation=0.5)


@pytest.mark.parametrize("first_stage", [True, False])
@pytest.mark.parametrize("augment", [False, True])
def test_pedestrian_dataset_matches_jax(first_stage, augment):
    kw = dict(scene="hotel", phase="train", first_stage=first_stage, synthetic_scenes=6,
              shift=0.5, scale=2.0, **(PED_AUG if augment else {}))
    j, t = jped.PedestrianDataset(**kw), tped.PedestrianDataset(**kw)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert len(t) == len(j) == 6
    for idx in range(len(j)):
        _assert_same(t.sample(idx, np.random.default_rng(idx)),
                     j.sample(idx, np.random.default_rng(idx)))
    if not first_stage:
        idx = np.array([4, 0, 5, 2])
        _assert_same(t.sample_batch(idx, np.random.default_rng(3)),
                     j.sample_batch(idx, np.random.default_rng(3)))


def test_pedestrian_split_files_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    np.save(tmp_path / "zara1_data_test.npy", rng.standard_normal((3, 10, 20, 2)))
    np.save(tmp_path / "zara1_num_test.npy", np.array([2, 10, 5]))
    for phase in ("test", "train"):  # train: no files, the synthetic scenes
        want = jped.load_pedestrian_split(str(tmp_path), "zara1", phase, traj_scale=2.0)
        got = tped.load_pedestrian_split(str(tmp_path), "zara1", phase, traj_scale=2.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


NBA_AUG = dict(flip=True, rand_rotation=True, rand_translation=0.3)


@pytest.mark.parametrize("first_stage", [True, False])
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_nba_dataset_matches_jax(first_stage, augment, split):
    kw = dict(scene="rebound", first_stage=first_stage, synthetic_games=3, split=split,
              shift=jreg.NBA_SHIFT["rebound"], scale=jreg.NBA_SCALE["rebound"],
              **(NBA_AUG if augment else {}))
    j, t = jnba.NBADataset(**kw), tnba.NBADataset(**kw)
    assert len(t) == len(j) and t.cumulative_sizes == j.cumulative_sizes
    for gt, gj in zip(t.games, j.games):
        _assert_same(gt, gj)
    for idx in (0, 7, len(j) - 1):
        _assert_same(t.sample(idx, np.random.default_rng(idx)),
                     j.sample(idx, np.random.default_rng(idx)))
    if not first_stage:
        idx = np.array([len(j) - 1, 0, 50, 3, 44, 45])
        _assert_same(t.sample_batch(idx, np.random.default_rng(4)),
                     j.sample_batch(idx, np.random.default_rng(4)))


def test_nba_game_files_match_jax(tmp_path):
    """A flat directory of game files: the filename-hash holdout splits it
    the same way; a game shorter than the window is skipped."""
    rng = np.random.default_rng(12)
    names = [f"game{i:03d}.npz" for i in range(12)]
    for i, name in enumerate(names):
        f = 15 if i == 3 else 30
        np.savez(tmp_path / name, pos=rng.standard_normal((f, 11, 2)) * 10 + 47,
                 team=rng.integers(0, 3, (f, 11)), group=rng.integers(0, 2, (f, 11)),
                 agent_id=np.broadcast_to(np.arange(11), (f, 11)))
    assert {jnba._holdout_is_test(n) for n in names} == {True, False}
    for split in ("train", "test"):
        assert [tnba._holdout_is_test(n) for n in names] == [jnba._holdout_is_test(n)
                                                             for n in names]
        want = jnba.load_nba_games(str(tmp_path), "score", 20, np.asarray(1.0),
                                   np.asarray(2.0), split=split)
        got = tnba.load_nba_games(str(tmp_path), "score", 20, np.asarray(1.0),
                                  np.asarray(2.0), split=split)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_same(g, w)


# ---------------------------------------------------------------- first stages

FS_SMALL = dict(dim_input=16, dim_latent=8, dim_entity=16, dim_head_cross=8,
                dim_head_latent=8, num_head_cross=2)
FIRST = {
    "pedestrian": (jped_c.PedestrianFirstStageConfig, jped_c.build_pedestrian_first_stage,
                   jped_c.make_pedestrian_first_stage_loss, tped_c.PedestrianFirstStageConfig,
                   tped_c.build_pedestrian_first_stage, tped_c.make_pedestrian_first_stage_loss,
                   dict(scene="univ", phase="train", synthetic_scenes=8)),
    "nba": (jnba_c.NBAFirstStageConfig, jnba_c.build_nba_first_stage,
            jnba_c.make_nba_first_stage_loss, tnba_c.NBAFirstStageConfig,
            tnba_c.build_nba_first_stage, tnba_c.make_nba_first_stage_loss,
            dict(scene="score", synthetic_games=8, flip=True, shift=47.0, scale=25.0)),
}


def _first_stage_batch(workload, n_entities, b=6):
    from lam_slide_tpu_torch.data.collate import pad_collate

    ds_kw = FIRST[workload][-1]
    ds = (tped.PedestrianDataset(**ds_kw) if workload == "pedestrian"
          else tnba.NBADataset(**ds_kw))
    rng = np.random.default_rng(13)
    samples = [ds.sample(i % len(ds), rng) for i in range(b)]
    if workload == "nba":  # fewer players in some frames: padded rows
        for s in samples[:2]:
            for key in ("pos", "team", "group", "agent_id", "entities"):
                s[key] = s[key][:7]
    return pad_collate(samples, num_entities=n_entities)


@pytest.mark.parametrize("workload", sorted(FIRST))
def test_first_stage_forward_and_loss_match_jax(workload):
    """The first stage at a small width on weights from the JAX init carried
    over by ``convert.first_stage_state_dict_from_jax``: every decoded head
    and the loss with its parts within LOSS_TOL; NBA's classification
    metrics (argmax over the heads) equal."""
    jcfg_cls, jbuild, jloss, tcfg_cls, tbuild, tloss, _ = FIRST[workload]
    kw = dict(FS_SMALL, scale=3.0)
    jcfg, tcfg = jcfg_cls(**kw), tcfg_cls(**kw)
    batch = _first_stage_batch(workload, jcfg.num_entities)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbuild(jcfg)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jb))
    jout = jmodel.apply(variables, jb)
    jtotal, jmetrics = jloss(jmodel, jcfg)(variables["params"], variables["constants"], jb,
                                           jax.random.PRNGKey(1), False)
    model = tbuild(tcfg, device="cpu").eval()
    model.load_state_dict(convert.first_stage_state_dict_from_jax(variables["params"],
                                                                  variables["constants"]))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tb)
        total, metrics = tloss(tcfg)(model, tb, None, False)
    assert set(out) == set(jout)
    for k in jout:
        _close(out[k], jout[k], LOSS_TOL, k)
    _close(total, jtotal, LOSS_TOL, "loss")
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        if "accuracy" in k or "precision" in k or "recall" in k:
            assert metrics[k].item() == float(v), k
        else:
            _close(metrics[k], v, LOSS_TOL, k)


def test_classification_metrics_match_jax():
    rng = np.random.default_rng(14)
    for n_classes in (2, 3):
        logits = rng.standard_normal((5, 11, n_classes)).astype(np.float32)
        targets = rng.integers(0, n_classes, (5, 11))
        mask = rng.random((5, 11)) > 0.25
        want = jnba_c.classification_metrics(jnp.asarray(logits), jnp.asarray(targets),
                                             jnp.asarray(mask))
        got = tnba_c.classification_metrics(torch.from_numpy(logits), torch.from_numpy(targets),
                                            torch.from_numpy(mask))
        assert {k: v.item() for k, v in got.items()} == {k: float(v) for k, v in want.items()}
