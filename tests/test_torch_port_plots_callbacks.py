"""The port's analysis/plots.py and analysis/callbacks.py against the JAX
package's, on the CPU (matplotlib on the Agg backend).

* Each of the 15 figure functions, fed the same numpy data on both sides:
  the data of every artist they draw (lines, collections and their 3D
  offsets, images, bars, texts, titles and labels) equal to JAX's;
* the plots module imports without matplotlib (it is imported when a figure
  is drawn), and a figure without it raises;
* ``make_peptide_sampling_hook`` on the port's smoke 4AA second stage: its
  cadence, one ``RolloutSampler`` for every epoch, the epoch's EMA weights
  under the sampler's backbone (the model's own after the hook), the
  per-trajectory error handling, and its summary against JAX's
  ``evaluate_peptides`` on the same injected samples within 1e-6; with
  ``figures`` the epoch's PNG;
* ``make_pointcloud_vis_hook``: ``vis_rmse`` and the PNG against JAX's hook
  on the same prediction, and its cadence.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.func import functional_call

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from lam_slide_tpu.analysis import callbacks as jcallbacks  # noqa: E402
from lam_slide_tpu.analysis import eval_peptide as jeval  # noqa: E402
from lam_slide_tpu.analysis import plots as jplots  # noqa: E402
from lam_slide_tpu_torch.analysis import callbacks as tcallbacks  # noqa: E402
from lam_slide_tpu_torch.analysis import plots as tplots  # noqa: E402
from lam_slide_tpu_torch.analysis import rollout as trollout  # noqa: E402
from lam_slide_tpu_torch.experiments import registry as treg  # noqa: E402

SUMMARY_ATOL = 1e-6
RNG = np.random.default_rng(0)
TORSIONS = (RNG.uniform(-np.pi, np.pi, (400, 3)), RNG.uniform(-np.pi, np.pi, (400, 3)))
TORSIONS2 = (RNG.uniform(-np.pi, np.pi, 300), RNG.uniform(-np.pi, np.pi, 300))
TIC = RNG.standard_normal((2, 300))
PER_PEPTIDE = {"AAAA": {"JSD": {"phi|psi": 0.1, "phi": 0.2, "psi": 0.3, "chi1": 0.05},
                        "ref_metastable_probs": [0.5, 0.3, 0.2],
                        "traj_metastable_probs": [0.4, 0.4, 0.2]},
               "CDEF": {"JSD": {"phi": 0.15, "psi": 0.25}}}
POS3 = RNG.standard_normal((12, 3))
TYPES = ["C", "N", "O", "H", "C", "S", "C", "N", "O", "H", "C", "X"]


def _ax(mod):
    return plt.subplots()[1]


# (name, call(module) -> figure, axes or tuple)
FIGURES = [
    ("ramachandran", lambda m: m.ramachandran(TORSIONS[0][:, 0], TORSIONS[1][:, 0], title="r")),
    ("free_energy_surface", lambda m: m.free_energy_surface(TIC[0], TIC[1], title="f")),
    ("feature_histograms", lambda m: m.feature_histograms(RNG_FEATS, labels=list("abcd"))),
    ("point_cloud", lambda m: m.point_cloud(POS3, color="k", title="p")),
    ("trajectories_2d", lambda m: m.trajectories_2d(TRAJ, mask=np.array([1, 0, 1], bool),
                                                   cond_end=3, title="t")),
    ("eval_summary_figure", lambda m: m.eval_summary_figure(PER_PEPTIDE)),
    ("ramachandran_lognorm", lambda m: m.ramachandran_lognorm(
        _ax(m), (TORSIONS2[0], TORSIONS2[1]), title="l", show_initial=True, bins=40)),
    ("ramachandran_grid", lambda m: m.ramachandran_grid(TORSIONS, title="g", bins=30)),
    ("ramachandran_grid_one_pair", lambda m: m.ramachandran_grid(TORSIONS2, bins=30)),
    ("dual_ramachandran", lambda m: m.dual_ramachandran(TORSIONS2, TORSIONS2[::-1], bins=30)),
    ("tic2d_comparison", lambda m: m.tic2d_comparison(TIC[0], TIC[1], TIC[1], TIC[0])),
    ("free_energy_comparison", lambda m: m.free_energy_comparison(TIC[0], TIC[1], bins=40)),
    ("scatter_3d_comparison", lambda m: m.scatter_3d_comparison(POS3, TYPES, POS3 + 0.1, TYPES,
                                                               title="s")),
    ("density_point_cloud", lambda m: m.density_point_cloud(
        RNG_POINTS, RNG_DENS, atoms_pos=POS3[:4], atom_types=TYPES[:4], dens_threshold=0.2)),
    ("density_channels", lambda m: m.density_channels(
        RNG_POINTS, {"C": RNG_DENS, "N": RNG_DENS[::-1], "O": RNG_DENS ** 2})),
    ("pedestrian_trajectory", lambda m: m.pedestrian_trajectory(TRAJ, title="ped")),
]
RNG_FEATS = RNG.uniform(-np.pi, np.pi, (200, 4))
RNG_POINTS = RNG.uniform(0, 1, (200, 3))
RNG_DENS = RNG.uniform(0, 1, 200)
TRAJ = np.cumsum(RNG.standard_normal((10, 3, 2)), axis=0)


def _fingerprint(obj) -> list:
    """Every drawn artist's data on every axes of the figure ``obj`` is on."""
    if isinstance(obj, tuple):
        obj = obj[0]
    fig = obj if isinstance(obj, matplotlib.figure.Figure) else obj.figure
    out = []
    for ax in fig.axes:
        out.append(("axes", ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.get_xlim(),
                    ax.get_ylim(), [t.get_text() for t in ax.get_xticklabels()]))
        for line in ax.lines:
            out.append(("line", line.get_xydata(), line.get_linestyle(), line.get_label()))
        for coll in ax.collections:
            out.append(("collection", type(coll).__name__, coll.get_offsets(),
                        getattr(coll, "_offsets3d", None), coll.get_array(),
                        [p.vertices for p in coll.get_paths()], coll.get_facecolor(),
                        coll.get_edgecolor()))
        for im in ax.images:
            out.append(("image", im.get_array(), im.get_extent()))
        for patch in ax.patches:
            out.append(("patch", patch.get_xy(), patch.get_width(), patch.get_height()))
        for text in ax.texts:
            out.append(("text", text.get_text(), text.get_position()))
        legend = ax.get_legend()
        if legend is not None:
            out.append(("legend", [t.get_text() for t in legend.get_texts()]))
    return out


def _assert_same(got, want, where="figure"):
    assert type(got) is type(want) or (isinstance(got, np.ndarray) and
                                       isinstance(want, np.ndarray)), where
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype != object:
        np.testing.assert_array_equal(np.ma.filled(np.ma.asarray(got), np.nan),
                                      np.ma.filled(np.ma.asarray(want), np.nan), err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name,call", FIGURES, ids=[f[0] for f in FIGURES])
def test_figure_matches_jax(name, call):
    plt.close("all")
    want = _fingerprint(call(jplots))
    got = _fingerprint(call(tplots))
    assert len(want) > 1
    _assert_same(got, want, name)
    plt.close("all")


def test_plots_import_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import lam_slide_tpu_torch.analysis.plots as p, lam_slide_tpu_torch.analysis."
            "callbacks, lam_slide_tpu_torch.analysis.eval_cli\n"
            "try:\n    p.ramachandran([0.0], [0.0])\nexcept ImportError:\n    print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"


# ---------------------------------------------------------------- hooks

@pytest.fixture(scope="module")
def pep(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAM_SLIDE_NO_DATA_CACHE", "1")
        exp = treg.peptide_second_stage(smoke=True, device="cpu")
    from lam_slide_tpu_torch.data.peptide import PeptideDataset

    ds = PeptideDataset(first_stage=False, synthetic_peptides=3, synthetic_frames=200,
                        n_timesteps=8, num_entities=8)
    return exp, ds.trajectories


def _state(model):
    from lam_slide_tpu_torch.train import create_train_state
    from lam_slide_tpu_torch.train.optim import AdamW

    state = create_train_state(model, AdamW(lambda c: 1e-3, 0.0))
    g = torch.Generator().manual_seed(3)
    for v in state.ema_params.values():
        v.add_(0.05 * torch.randn(v.shape, generator=g))
    return state


def _injected(trajectories, num_rollouts, t_len):
    rng = np.random.default_rng(11)
    out = {}
    for traj in trajectories:
        n = num_rollouts * t_len
        out[traj["name"]] = (traj["atom14_pos"][:n]
                             + 0.05 * rng.standard_normal(traj["atom14_pos"][:n].shape))
    return out


def test_sampling_hook_matches_jax_evaluation(pep, tmp_path, monkeypatch, capsys):
    exp, trajectories = pep
    state = _state(exp.model)
    samples = _injected(trajectories, 2, exp.second_stage.num_timesteps)
    built, seen = [], []
    real = trollout.RolloutSampler

    class Stub(real):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

        def sample_rollout(self, generator, cond_pos, res, res_mask, num_rollouts=1):
            probe = _probe(self.ss.backbone, exp.model)
            seen.append((probe, int(generator.initial_seed())))
            name = next(n for n, t in zip(samples, trajectories)
                        if np.array_equal(t["atom14_pos"][0], cond_pos))
            if name == trajectories[1]["name"]:
                raise RuntimeError("a failed rollout")
            return samples[name]

    monkeypatch.setattr(trollout, "RolloutSampler", Stub)
    hook = tcallbacks.make_peptide_sampling_hook(exp.second_stage, trajectories, str(tmp_path),
                                                 interval=2, num_rollouts=2, max_peptides=3,
                                                 figures=True)
    got = hook(state, epoch=4)
    assert hook(state, epoch=5) is None  # cadence
    assert hook(state, epoch=6) is not None
    assert len(built) == 1  # one sampler for every epoch
    assert "sampling hook failed for " + trajectories[1]["name"] in capsys.readouterr().out
    kept = {t["name"]: {"traj": samples[t["name"]], "ref": t["atom14_pos"],
                        "aatype": t["aatype"][0]}
            for i, t in enumerate(trajectories) if i != 1}
    t_ref = min(len(t["ref"]) for t in kept.values())
    _, want = jeval.evaluate_peptides(kept, jeval.EvalConfig(
        tica_lag=min(1000, t_ref // 2), run_msm=False, run_decorrelation=False))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= SUMMARY_ATOL, k
    on_ema, on_own = _probe(lambda *a: functional_call(exp.model, state.ema_params, a),
                            exp.model), _probe(exp.model, exp.model)
    assert not torch.equal(on_ema, on_own)
    for probe, seed in seen:
        torch.testing.assert_close(probe, on_ema, rtol=0, atol=0)
    assert {seed for _, seed in seen} == {137 + 4, 137 + 6}
    assert (tmp_path / "figures" / "epoch4.png").exists()
    torch.testing.assert_close(_probe(exp.second_stage.backbone, exp.model), on_own)


def _probe(fn, model):
    """fn's output on a fixed input of ``model``'s widths."""
    g = torch.Generator().manual_seed(5)
    d = model.x_in.in_features
    x = torch.randn(1, 8, 4, d, generator=g)
    with torch.no_grad():
        return fn(x, torch.full((1,), 0.3), torch.randn(1, 8, 4, d, generator=g),
                  torch.zeros(1, 8, 4, dtype=torch.int32))


def test_pointcloud_vis_hook_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    batch = {"pos": rng.standard_normal((2, 6, 3)).astype(np.float32),
             "attention_mask": np.asarray([[1, 1, 1, 1, 0, 0]] * 2, bool)}
    z = np.asarray([6, 7, 8, 1, 6, 6])
    offset = rng.standard_normal((2, 6, 3)).astype(np.float32) * 0.1
    want = jcallbacks.make_pointcloud_vis_hook(lambda s, b: b["pos"] + offset, batch,
                                               str(tmp_path / "jax"), atom_types=z,
                                               interval=2)(None, 0)
    hook = tcallbacks.make_pointcloud_vis_hook(
        lambda s, b: torch.from_numpy(b["pos"] + offset), batch, str(tmp_path), atom_types=z,
        interval=2)
    got = hook(None, 0)
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    assert (tmp_path / "figures" / "pointcloud_epoch00000.png").exists()
    assert hook(None, 1) is None
    assert hook(None, 2) is not None
