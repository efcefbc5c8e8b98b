"""Evaluation figures (matplotlib, Agg backend): a copy of
``lam_slide_tpu/analysis/plots.py``'s figure functions.

The reference's plotting surface (src/utils/plots.py + src/utils/plotting.py
+ pyemma.plots usage): Ramachandran maps (LogNorm, single/grid/dual), TICA
contour comparisons with numbered metastable maxima, 1D free-energy
comparisons, 3D point-cloud / prediction-vs-ground-truth scatters,
occupancy-density clouds and channel grids, and pedestrian/NBA trajectory
overlays; the plotly figures of the reference become matplotlib equivalents
carrying the same information. Figures return the matplotlib Figure/Axes;
callers save.

matplotlib is imported when a figure is drawn, not with the module, so the
package imports where matplotlib is absent (the card's machine); a figure
there raises ``ModuleNotFoundError``.
"""

from typing import Mapping, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend (imported on first use)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def ramachandran(phi: np.ndarray, psi: np.ndarray, ax=None, bins: int = 64, title=""):
    """2D φ/ψ density map (plots.py ramachandran figures)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    h, xe, ye = np.histogram2d(
        phi, psi, bins=bins, range=[[-np.pi, np.pi], [-np.pi, np.pi]], density=True
    )
    ax.imshow(h.T + 1e-12, origin="lower", extent=(-np.pi, np.pi, -np.pi, np.pi),
              aspect="auto", cmap="viridis")
    ax.set_xlabel(r"$\phi$")
    ax.set_ylabel(r"$\psi$")
    ax.set_title(title)
    return ax


def free_energy_surface(x: np.ndarray, y: np.ndarray, ax=None, bins: int = 50,
                        kt: float = 1.0, title=""):
    """-kT log p(x, y) surface (pyemma.plots.plot_free_energy equivalent)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    h, xe, ye = np.histogram2d(x, y, bins=bins, density=True)
    f = -kt * np.log(h.T + 1e-12)
    f -= f.min()
    im = ax.contourf(0.5 * (xe[:-1] + xe[1:]), 0.5 * (ye[:-1] + ye[1:]), f,
                     levels=20, cmap="nipy_spectral")
    ax.set_title(title)
    return ax, im


def feature_histograms(feats: np.ndarray, labels: Optional[Sequence[str]] = None,
                       ax=None, color="C0", range_=(-np.pi, np.pi)):
    """Stacked per-feature histograms (pyemma.plots.plot_feature_histograms)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 1 + feats.shape[1] * 0.5))
    for i in range(feats.shape[1]):
        h, e = np.histogram(feats[:, i], bins=60, range=range_, density=True)
        ax.plot(0.5 * (e[:-1] + e[1:]), h / max(h.max(), 1e-12) * 0.9 + i, color=color)
        if labels is not None:
            ax.text(range_[0], i + 0.4, labels[i], fontsize=7, va="center")
    ax.set_yticks([])
    return ax


def point_cloud(pos: np.ndarray, ax=None, color=None, title=""):
    """3D scatter of a molecular frame (plotting.py pointcloud figures)."""
    plt = _pyplot()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=color, s=18)
    ax.set_title(title)
    return ax


def trajectories_2d(pos: np.ndarray, mask: Optional[np.ndarray] = None, ax=None,
                    cond_end: Optional[int] = None, title=""):
    """Pedestrian/NBA 2D trajectory overlay: pos [T, N, 2]
    (plotting.py pedestrian figures)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    t, n = pos.shape[:2]
    for a in range(n):
        if mask is not None and not mask[a]:
            continue
        ax.plot(pos[:, a, 0], pos[:, a, 1], lw=1.0, alpha=0.8)
        if cond_end is not None:
            ax.plot(pos[:cond_end, a, 0], pos[:cond_end, a, 1], lw=2.5, alpha=0.9)
        ax.scatter(pos[-1, a, 0], pos[-1, a, 1], s=12)
    ax.set_aspect("equal")
    ax.set_title(title)
    return ax


def eval_summary_figure(per_peptide: dict, path: Optional[str] = None):
    """Grid figure per evaluated peptide: torsion JSD bars + metastable probs
    (condensed version of the reference's 4x4 eval figure)."""
    plt = _pyplot()
    names = list(per_peptide)
    fig, axes = plt.subplots(len(names), 2, figsize=(10, 3 * len(names)), squeeze=False)
    for i, name in enumerate(names):
        m = per_peptide[name]
        jsd_items = [(k, v) for k, v in m["JSD"].items() if "|" not in k]
        axes[i, 0].bar(range(len(jsd_items)), [v for _, v in jsd_items])
        axes[i, 0].set_xticks(range(len(jsd_items)))
        axes[i, 0].set_xticklabels([k for k, _ in jsd_items], rotation=90, fontsize=6)
        axes[i, 0].set_title(f"{name} JSD")
        if "ref_metastable_probs" in m:
            w = 0.4
            x = np.arange(len(m["ref_metastable_probs"]))
            axes[i, 1].bar(x - w / 2, m["ref_metastable_probs"], w, label="MD")
            axes[i, 1].bar(x + w / 2, m["traj_metastable_probs"], w, label="ours")
            axes[i, 1].legend(fontsize=7)
            axes[i, 1].set_title("metastable occupation")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig

# Atom color convention shared by the 3D figures (plotting.py ATOM_COLOR_MAP
# usage; the reference imports the map from its occupancy tooling).
ATOM_COLORS = {"C": "dimgray", "N": "tab:blue", "O": "tab:red", "S": "gold",
               "H": "lightgray", "P": "tab:orange"}


def ramachandran_lognorm(ax, torsions, title="", show_initial=False, bins=100):
    """Single LogNorm phi/psi histogram on ``ax`` (plots.py:138-177).

    torsions: (phi, psi) arrays in radians; ``show_initial`` marks the first
    frame with a red x.
    """
    _pyplot()
    from matplotlib.colors import LogNorm

    edges = np.linspace(-np.pi, np.pi, bins + 1)
    ax.hist2d(np.ravel(torsions[0]), np.ravel(torsions[1]),
              bins=[edges, edges], norm=LogNorm(), density=True)
    ax.set_xlim(-np.pi, np.pi)
    ax.set_ylim(-np.pi, np.pi)
    ax.set_xlabel("Phi")
    ax.set_ylabel("Psi")
    ax.set_title(title)
    if show_initial:
        ax.scatter(np.ravel(torsions[0])[0], np.ravel(torsions[1])[0],
                   marker="x", color="red", s=50)
    return ax


def ramachandran_grid(torsions, title="", show_initial=False, bins=100):
    """One- or three-pair Ramachandran figure (plotting.py:338-378).

    torsions: (phi, psi) with trailing axis 1 or 3 (4AA has 3 interior
    residue pairs). Returns the Figure.
    """
    plt = _pyplot()
    phi, psi = np.asarray(torsions[0]), np.asarray(torsions[1])
    if phi.ndim == 1 or phi.shape[-1] == 1:
        fig, ax = plt.subplots(figsize=(6, 6))
        ramachandran_lognorm(ax, (phi, psi), title or "MD", show_initial, bins)
        return fig
    if phi.shape[-1] == 3:
        fig, axs = plt.subplots(1, 3, figsize=(18, 6))
        for i in range(3):
            ramachandran_lognorm(axs[i], (phi[:, i], psi[:, i]), title,
                                 show_initial, bins)
        return fig
    raise NotImplementedError(
        "Ramachandran plot only implemented for one or three angle pairs."
    )


def dual_ramachandran(torsions1, torsions2, title1="MD", title2="model",
                      show_initial=False, bins=100):
    """Side-by-side phi/psi comparison, shared y (plotting.py:382-457)."""
    plt = _pyplot()
    fig, axs = plt.subplots(1, 2, figsize=(12, 6), gridspec_kw={"wspace": 0})
    for ax, tors, title in ((axs[0], torsions1, title1), (axs[1], torsions2, title2)):
        ramachandran_lognorm(ax, tors, title, show_initial, bins)
        ax.label_outer()
    axs[1].tick_params(left=False)
    axs[1].set_ylabel("")
    return fig


def tic2d_comparison(tic0_ref, tic1_ref, tic0_model=None, tic1_model=None,
                     name="model", thresh=0.013, sigma=1.0, ax=None):
    """Reference-density TICA contours with numbered metastable maxima
    (plots.py:8-101): Gaussian-KDE of the MD reference on a 200x200 grid,
    sub-threshold mass blanked, smoothed contours, local maxima labeled;
    model samples overlaid as a scatter when given.
    """
    plt = _pyplot()
    from scipy.ndimage import gaussian_filter, maximum_filter
    from scipy.stats import gaussian_kde

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 6))
    kde = gaussian_kde(np.vstack([tic0_ref, tic1_ref]))
    xs = np.linspace(np.min(tic0_ref), np.max(tic0_ref), 200)
    ys = np.linspace(np.min(tic1_ref), np.max(tic1_ref), 200)
    gx, gy = np.meshgrid(xs, ys)
    z = kde(np.vstack([gx.ravel(), gy.ravel()])).reshape(gx.shape)
    # smooth FIRST, then blank: gaussian_filter propagates NaN outward
    # (~4 sigma per blanked cell), eroding basin boundaries and deleting
    # narrow basins entirely if the mask is applied before smoothing
    z = gaussian_filter(z, sigma=sigma)
    z[z < thresh] = np.nan
    ax.contour(gx, gy, z, levels=15, cmap="viridis", linewidths=2.0, alpha=0.8)

    if tic0_model is not None:
        ax.scatter(tic0_model, tic1_model, s=2, alpha=0.15, color="tab:orange",
                   label=name, rasterized=True)
        ax.legend(loc="upper right")

    local_max = (maximum_filter(np.nan_to_num(z, nan=-np.inf), size=20) == z)
    idx = 1
    for yy, xx in np.argwhere(local_max & ~np.isnan(z)):
        ax.text(gx[0, xx], gy[yy, 0], str(idx), fontsize=14, fontweight="bold",
                ha="center", va="center")
        idx += 1
    ax.set_xlabel("TIC 0")
    ax.set_ylabel("TIC 1")
    return ax


def free_energy_comparison(feat_ref, feat_model, name="model", xlabel="TIC 0",
                           bins=100, ax=None):
    """1D free-energy curves -log(p/p_max): MD (solid) vs model (dashed)
    over the reference's bin range (plots.py:103-135)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 6))
    edges = np.linspace(np.min(feat_ref), np.max(feat_ref), bins)
    for feats, label, style in ((feat_ref, "MD", "-"), (feat_model, name, "--")):
        h, e = np.histogram(feats, bins=edges, density=True)
        with np.errstate(divide="ignore"):
            f = -np.log(h / max(h.max(), 1e-300))
        ax.plot(0.5 * (e[1:] + e[:-1]), f, lw=3, linestyle=style, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(r"Free energy/$k_B$T")
    ax.legend()
    return ax


def scatter_3d_comparison(pred_pos, pred_types=None, gt_pos=None, gt_types=None,
                          ax_range=(-1, 1), title=""):
    """Prediction vs ground-truth 3D scatter (plotting.py:25-77): predictions
    as filled circles, ground truth as open diamonds, colored by atom type
    (element symbols or any hashable labels). Matplotlib stand-in for the
    reference's plotly figure. Returns the Figure."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")

    def colors(types, n):
        if types is None:
            return ["tab:blue"] * n
        return [ATOM_COLORS.get(t, f"C{abs(hash(t)) % 10}") for t in types]

    pred_pos = np.asarray(pred_pos)
    ax.scatter(pred_pos[:, 0], pred_pos[:, 1], pred_pos[:, 2], s=30,
               c=colors(pred_types, len(pred_pos)), label="Predictions")
    if gt_pos is not None:
        gt_pos = np.asarray(gt_pos)
        ax.scatter(gt_pos[:, 0], gt_pos[:, 1], gt_pos[:, 2], s=60, marker="d",
                   facecolors="none", edgecolors=colors(gt_types, len(gt_pos)),
                   label="Ground Truth")
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(*ax_range)
    ax.set_box_aspect((1, 1, 1))
    ax.set_title(title)
    ax.legend()
    return fig


def density_point_cloud(points, density, atoms_pos=None, atom_types=None,
                        dens_threshold=0.0, ax_range=(0, 1), title=""):
    """Occupancy/density cloud in the unit box (plotting.py:131-178):
    grid points colored by density (viridis), true atoms overlaid as open
    diamonds. points [N, 3], density [N]."""
    plt = _pyplot()
    points = np.asarray(points)
    density = np.asarray(density)
    keep = density > dens_threshold
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    p = ax.scatter(points[keep, 0], points[keep, 1], points[keep, 2],
                   c=density[keep], cmap="viridis", s=8, alpha=0.6)
    fig.colorbar(p, ax=ax, label="Dens", shrink=0.7)
    if atoms_pos is not None:
        atoms_pos = np.asarray(atoms_pos)
        cols = ([ATOM_COLORS.get(t, "k") for t in atom_types]
                if atom_types is not None else "k")
        ax.scatter(atoms_pos[:, 0], atoms_pos[:, 1], atoms_pos[:, 2], s=70,
                   marker="d", facecolors="none", edgecolors=cols)
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(*ax_range)
    ax.set_box_aspect((1, 1, 1))
    ax.set_title(title)
    return fig


def density_channels(points, channel_density: Mapping[str, np.ndarray],
                     dens_threshold=0.01, ax_range=(0, 1)):
    """Per-atom-channel density clouds on a 2-column grid of 3D axes
    (plotting.py:181-246,458-520): one subplot per channel, points above
    threshold colored by that channel's density."""
    plt = _pyplot()
    names = list(channel_density)
    rows = (len(names) + 1) // 2
    fig = plt.figure(figsize=(12, 5 * rows))
    points = np.asarray(points)
    for i, name in enumerate(names):
        ax = fig.add_subplot(rows, 2, i + 1, projection="3d")
        dens = np.asarray(channel_density[name])
        keep = dens > dens_threshold
        ax.scatter(points[keep, 0], points[keep, 1], points[keep, 2],
                   c=dens[keep], cmap="viridis", s=8, alpha=0.6)
        for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
            setter(*ax_range)
        ax.set_box_aspect((1, 1, 1))
        ax.set_title(name)
    fig.tight_layout()
    return fig


def pedestrian_trajectory(pos, x_min=None, x_max=None, y_min=None, y_max=None,
                          padding=0.1, title=None, n_frames=6):
    """Scene overview for pos [T, N, 2] (plotting.py:521-666): the reference
    builds an animated plotly figure; this static equivalent draws each
    agent's trail plus ``n_frames`` time-colored marker snapshots, with the
    same auto-ranging (min/max per axis padded by ``padding``). Returns the
    Figure."""
    plt = _pyplot()
    pos = np.asarray(pos)
    t = pos.shape[0]

    def lim(lo, hi, given_lo, given_hi):
        pad = padding * (hi - lo)
        return (lo - pad if given_lo is None else given_lo,
                hi + pad if given_hi is None else given_hi)

    xlim = lim(pos[..., 0].min(), pos[..., 0].max(), x_min, x_max)
    ylim = lim(pos[..., 1].min(), pos[..., 1].max(), y_min, y_max)

    fig, ax = plt.subplots(figsize=(8, 8))
    cmap = plt.get_cmap("viridis")
    for a in range(pos.shape[1]):
        ax.plot(pos[:, a, 0], pos[:, a, 1], lw=0.8, alpha=0.5,
                color=cmap(a / max(pos.shape[1] - 1, 1)))
    frames = np.unique(np.linspace(0, t - 1, n_frames).astype(int))
    for f in frames:
        ax.scatter(pos[f, :, 0], pos[f, :, 1], s=30,
                   c=np.arange(pos.shape[1]), cmap="viridis",
                   alpha=0.3 + 0.7 * f / max(t - 1, 1), edgecolors="none")
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_xlabel("X Position")
    ax.set_ylabel("Y Position")
    if title:
        ax.set_title(title)
    return fig
