"""Markov state model estimation + PCCA+ metastable coarse-graining.

Numpy reimplementation of the pyemma pipeline the reference drives
(src/modules/analysis.py:42-56): k-means discretization (k=100, fixed seed
137), transition-matrix estimation at a lag, PCCA+ into 10 metastable
states, coarse MSM over metastable assignments, and the metastable
occupation probabilities whose JSD is the headline 4AA MSM metric.

Estimation detail: like pyemma's ``estimate_markov_model``, the default
estimator is the REVERSIBLE MAXIMUM LIKELIHOOD transition matrix, computed
by the standard fixed-point iteration on the symmetric flow matrix
(Trendelkamp-Schroer et al., J. Chem. Phys. 143, 174101 (2015), eq. 31):

    x_ij ← (C_ij + C_ji) / (c_i/x_i + c_j/x_j),   T_ij = x_ij / x_i,

which maximizes Σ C_ij log T_ij over detailed-balance transition matrices.
PCCA+ follows the Deuflhard–Weber (2005) inner-simplex variant.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """[T, k] squared distances via the expansion identity — avoids the
    [T, k, D] broadcast temporary (multi-GB at real MD trajectory sizes)."""
    d = ((x * x).sum(1)[:, None] + (centers * centers).sum(1)[None, :]
         - 2.0 * (x @ centers.T))
    return np.maximum(d, 0.0)


def kmeans_discretize(
    x: np.ndarray, k: int = 100, max_iter: int = 100, seed: int = 137
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means with k-means++ init → (centers [k, D], assignments [T])."""
    rng = np.random.default_rng(seed)
    n = len(x)
    # k-means++ seeding
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.integers(n)]
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / d2.sum()
        centers[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, axis=1))
    for _ in range(max_iter):
        a = _sq_dists(x, centers).argmin(1)
        new_centers = centers.copy()
        for c in range(k):
            sel = a == c
            if sel.any():
                new_centers[c] = x[sel].mean(0)
        if np.allclose(new_centers, centers):
            return centers, a  # converged: `a` is the assignment for these centers
        centers = new_centers
    return centers, _sq_dists(x, centers).argmin(1)


def assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    return _sq_dists(x, centers).argmin(1)


def count_matrix(dtraj: np.ndarray, n_states: int, lag: int) -> np.ndarray:
    c = np.zeros((n_states, n_states))
    np.add.at(c, (dtraj[:-lag], dtraj[lag:]), 1.0)
    return c


def transition_matrix(
    dtraj: np.ndarray, n_states: int, lag: int, reversible: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (T over the largest connected active set, active_set indices).

    reversible=True → reversible MLE (pyemma estimate_markov_model
    semantics); False → plain row-normalized counts."""
    c = count_matrix(dtraj, n_states, lag)
    if reversible:
        # largest connected set under the symmetrized counts (the
        # reversible likelihood only couples states through C + Cᵀ)
        active = _largest_connected_set((c + c.T) > 0)
        t = reversible_mle(c[np.ix_(active, active)])
    else:
        # row-normalized counts need every active state to have outgoing
        # raw counts, or its row would be all-zero (non-stochastic T):
        # restrict to the largest STRONGLY connected component of the
        # directed count graph (pyemma's default connectivity).
        active = _largest_scc(c > 0)
        csub = c[np.ix_(active, active)]
        rows = csub.sum(1)
        t = csub / np.maximum(rows[:, None], 1e-12)
    return t, active


def reversible_mle(c: np.ndarray, tol: float = 1e-12, max_iter: int = 100000) -> np.ndarray:
    """Reversible maximum-likelihood transition matrix from counts C.

    Fixed-point iteration on the symmetric flows x_ij (see module
    docstring); the stationary distribution is the row sum of the
    converged x. Zeros of C + Cᵀ stay exactly zero.
    """
    tiny = 1e-300
    csym = c + c.T
    rows = c.sum(1)
    x = csym / max(csym.sum(), tiny)
    for _ in range(max_iter):
        xi = x.sum(1)
        q = rows / np.maximum(xi, tiny)
        x_new = csym / np.maximum(q[:, None] + q[None, :], tiny)
        x_new /= max(x_new.sum(), tiny)
        delta = np.abs(x_new - x).max()
        x = x_new
        if delta < tol:
            break
    xi = x.sum(1)
    return x / np.maximum(xi[:, None], tiny)


def _largest_connected_set(adj: np.ndarray) -> np.ndarray:
    n = len(adj)
    seen = np.zeros(n, bool)
    best: list = []
    for s in range(n):
        if seen[s]:
            continue
        comp = []
        stack = [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in np.nonzero(adj[u] | adj[:, u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        if len(comp) > len(best):
            best = comp
    return np.sort(np.asarray(best))


def _largest_scc(adj: np.ndarray) -> np.ndarray:
    """Largest strongly connected component (iterative Kosaraju)."""
    n = len(adj)

    def dfs_order(a):
        seen = np.zeros(n, bool)
        order = []
        for s in range(n):
            if seen[s]:
                continue
            stack = [(s, iter(np.nonzero(a[s])[0]))]
            seen[s] = True
            while stack:
                u, it = stack[-1]
                advanced = False
                for v in it:
                    if not seen[v]:
                        seen[v] = True
                        stack.append((int(v), iter(np.nonzero(a[v])[0])))
                        advanced = True
                        break
                if not advanced:
                    order.append(u)
                    stack.pop()
        return order

    order = dfs_order(adj)
    seen = np.zeros(n, bool)
    best: list = []
    for s in reversed(order):
        if seen[s]:
            continue
        comp = []
        stack = [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in np.nonzero(adj[:, u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        # A size-1 SCC without a self-loop has no outgoing counts inside
        # the component — restricting to it would yield an all-zero row
        # (non-stochastic T). Only closed components are valid candidates;
        # any SCC of size >1 is closed by strong connectivity.
        if (len(comp) > 1 or adj[comp[0], comp[0]]) and len(comp) > len(best):
            best = comp
    if not best:
        raise ValueError(
            "count graph has no closed communication class (no state "
            "revisits itself at this lag) — cannot estimate a Markov model"
        )
    return np.sort(np.asarray(best, dtype=int))


def stationary_distribution(t: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eig(t.T)
    idx = np.argmin(np.abs(vals - 1.0))
    pi = np.real(vecs[:, idx])
    pi = np.abs(pi)
    return pi / pi.sum()


def pcca_plus(t: np.ndarray, n_metastable: int) -> np.ndarray:
    """PCCA+ memberships [n_states, n_metastable] (Deuflhard–Weber).

    Uses the inner-simplex vertex selection on the dominant eigenvectors
    followed by the linear-transformation feasibility construction.
    """
    n = len(t)
    m = min(n_metastable, n)
    pi = stationary_distribution(t)
    # symmetrized (reversible) eigenproblem in the pi-weighted inner product
    d_half = np.diag(np.sqrt(pi))
    d_half_inv = np.diag(1.0 / np.maximum(np.sqrt(pi), 1e-12))
    ts = d_half @ t @ d_half_inv
    vals, vecs = np.linalg.eigh((ts + ts.T) / 2)
    order = np.argsort(-vals)[:m]
    chi_basis = d_half_inv @ vecs[:, order]  # right eigenvectors, first ≈ constant
    # normalize sign/scale of the first (stationary) eigenvector
    chi_basis = chi_basis / chi_basis[np.argmax(np.abs(chi_basis[:, 0])), 0]

    # inner simplex: pick m states spanning the eigenvector simplex
    verts = [int(np.argmax(np.linalg.norm(chi_basis - chi_basis.mean(0), axis=1)))]
    for _ in range(1, m):
        sub = chi_basis - chi_basis[verts[0]]
        q, _ = np.linalg.qr(sub[verts[1:]].T) if len(verts) > 1 else (np.zeros((m, 0)), None)
        resid = sub - sub @ q @ q.T
        dists = np.linalg.norm(resid, axis=1)
        dists[verts] = -1
        verts.append(int(np.argmax(dists)))

    a = np.linalg.pinv(chi_basis[verts])
    chi = chi_basis @ a
    # clamp to a valid membership matrix
    chi = np.clip(chi, 0.0, None)
    chi = chi / np.maximum(chi.sum(1, keepdims=True), 1e-12)
    return chi


@dataclass
class MSM:
    centers: np.ndarray            # k-means centers in TICA space
    transition: np.ndarray         # [n_active, n_active]
    active_set: np.ndarray
    memberships: np.ndarray        # [n_states_total, n_meta] (zero rows off-active)
    metastable_assignments: np.ndarray  # [n_states_total]
    pi: np.ndarray

    def discretize(self, x: np.ndarray) -> np.ndarray:
        """TICA coords → metastable state ids (analysis.py discretize)."""
        return self.metastable_assignments[assign(x, self.centers)]


def estimate_msm(
    tica_coords: np.ndarray,
    n_clusters: int = 100,
    n_metastable: int = 10,
    lag: int = 1000,
    seed: int = 137,
) -> MSM:
    """Full pipeline: kmeans → T → PCCA+ (analysis.py get_kmeans/get_msm)."""
    centers, dtraj = kmeans_discretize(tica_coords, k=n_clusters, seed=seed)
    t, active = transition_matrix(dtraj, n_clusters, lag)
    chi = pcca_plus(t, n_metastable)
    memberships = np.zeros((n_clusters, chi.shape[1]))
    memberships[active] = chi
    # Clusters outside the active set have no PCCA+ assignment. The
    # reference asserts all 100 clusters are active on its data
    # (analysis.py:51); when that doesn't hold (a generated trajectory
    # visiting regions the MD rarely connects), assigning them all to
    # state 0 would invent occupation mass in a real metastable state —
    # map each inactive cluster to the metastable state of its NEAREST
    # active cluster center instead (identical to the reference whenever
    # the active set is complete).
    meta_assign = np.zeros(n_clusters, dtype=np.int64)
    meta_assign[active] = chi.argmax(1)
    inactive = np.setdiff1d(np.arange(n_clusters), active)
    if len(inactive):
        nearest = assign(centers[inactive], centers[active])
        meta_assign[inactive] = meta_assign[active][nearest]
        memberships[inactive] = memberships[active][nearest]
    return MSM(
        centers=centers,
        transition=t,
        active_set=active,
        memberships=memberships,
        metastable_assignments=meta_assign,
        pi=stationary_distribution(t),
    )


def metastable_probs(meta_dtraj: np.ndarray, n_metastable: int = 10) -> np.ndarray:
    """Occupation frequencies (eval_peptide.py:252-254)."""
    return (meta_dtraj == np.arange(n_metastable)[:, None]).mean(1)


# ---------------------------------------------------------------------------
# Transition-path sampling utilities (reference analysis.py:70-109)
# ---------------------------------------------------------------------------


def sample_tp(
    trans: np.ndarray, start_state: int, end_state: int, traj_len: int,
    n_samples: int, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample discrete transition paths bridging start→end under a Markov
    chain: P(s_t | s_{t-1}, s_N) ∝ T[s_{t-1}, s_t] · (T^{N-t-1})[s_t, s_N]."""
    rng = rng or np.random.default_rng(0)
    n = traj_len
    powers = [np.linalg.matrix_power(trans, k) for k in range(n)]
    s_t = np.full(n_samples, start_state, dtype=int)
    states = [s_t]
    for t in range(1, n - 1):
        numerator = powers[n - t - 1][:, end_state] * trans[s_t, :]
        denom = powers[n - t][s_t, end_state][:, None]
        probs = numerator / np.maximum(denom, 1e-30)
        probs = probs / probs.sum(1, keepdims=True)
        s_t = np.array([rng.choice(len(trans), p=p) for p in probs])
        states.append(s_t)
    states.append(np.full(n_samples, end_state, dtype=int))
    return np.stack(states, axis=1)


def get_tp_likelihood(tp: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Per-step bridge transition probabilities of given paths
    (analysis.py:88-104). tp: [n_samples, N]."""
    n_samples, n = tp.shape
    s_n = tp[0, -1]
    powers = [np.linalg.matrix_power(trans, k) for k in range(n)]
    out = []
    for i in range(n - 1):
        t = i + 1
        s_t = tp[:, i]
        numerator = powers[n - t - 1][:, s_n] * trans[s_t, :]
        denom = powers[n - t][s_t, s_n][:, None]
        probs = numerator / np.maximum(denom, 1e-30)
        out.append(probs[np.arange(n_samples), tp[:, i + 1]])
    probs = np.stack(out, axis=1)
    probs[np.isnan(probs)] = 0.0
    return probs


def get_state_probs(tp: np.ndarray, num_states: int = 10) -> np.ndarray:
    """State occupation over a path ensemble (analysis.py:107-109)."""
    counts = np.bincount(tp.reshape(-1), minlength=num_states)
    return counts / counts.sum()
