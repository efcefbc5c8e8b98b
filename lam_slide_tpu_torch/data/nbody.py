"""N-body trajectory container + dataset (GeoTDM port), copied from
``lam_slide_tpu/data/nbody.py``. No registry experiment builds on it.

Numpy port of the reference's vendored GeoTDM trajectory layer
(src/datasets/geo_tdm/trajdata.py, trajdataset.py, nbody.py). Differences by
design, not omission:

- ``Trajectory`` is a plain time-major numpy container ([T, N, 3]) instead of
  a torch-geometric ``Data`` subclass with trailing time axis ([N, 3, T]) —
  time-major is the layout every collate/model in this framework consumes,
  so no permutes survive to device. The API surface mirrors TrajData:
  ``len`` = T, ``n_windows`` (trajdata.py:48-49), ``at`` time indexing
  (trajdata.py:68-90), ``cut`` (trajdata.py:92-98), ``roll`` autoregressive
  window advance (trajdata.py:100-110), ``snapshot`` (trajdata.py:112-140),
  ``state`` = stacked (x, v) (trajdata.py:56-58).
- Preprocessing caches with ``np.savez`` under a content-addressed name
  instead of pickling torch tensors (trajdataset.py:6-43).
- Edge features ARE built (unlike the MD17/pedestrian ports where the models
  never consume them): for NBody the charge/spring products are the physical
  interaction strengths, i.e. genuine per-sample payload (nbody.py:113-131).

When the raw GeoTDM ``.npy`` quadruple (loc_/vel_/edges_/charges_{suffix})
is absent, a deterministic synthetic system is simulated (leapfrog springs
or softened gravity) so tests and smoke runs need no download.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Union

import numpy as np

from lam_slide_tpu_torch.data.loader import Dataset
from lam_slide_tpu_torch.utils.rng import stable_seed

TimeIndex = Union[int, slice, Sequence[int], np.ndarray]


@dataclass
class Trajectory:
    """Time-major trajectory of one system: x [T, N, 3] (+v, node features h).

    Mirrors geo_tdm/trajdata.py::TrajData semantics with numpy arrays.
    ``extras`` carries any additional per-system payload (edge_index,
    edge_attr, system_id, ...) that time indexing must preserve
    (trajdata.py:83-89).
    """

    x: np.ndarray
    v: Optional[np.ndarray] = None
    h: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        self.x = np.asarray(self.x)
        if self.x.ndim == 2:  # single frame → length-1 trajectory (trajdata.py:151-155)
            self.x = self.x[None]
        if self.v is not None:
            self.v = np.asarray(self.v)
            if self.v.ndim == 2:
                self.v = self.v[None]
        if self.t is not None:
            self.t = np.atleast_1d(np.asarray(self.t))

    def __len__(self) -> int:
        return self.x.shape[0]

    def n_windows(self, span: int) -> int:
        """Number of length-``span`` sliding windows (trajdata.py:48-49)."""
        return len(self) - span + 1

    @property
    def state(self) -> np.ndarray:
        """Stacked (x, v) along a trailing axis: [T, N, 3, 2] (trajdata.py:56-58)."""
        assert self.v is not None, "state requires velocities"
        return np.stack((self.x, self.v), axis=-1)

    def at(self, t_idx: TimeIndex) -> "Trajectory":
        """New Trajectory restricted to time index ``t_idx`` (trajdata.py:68-90)."""
        if isinstance(t_idx, tuple):
            t_idx = list(t_idx)
        return Trajectory(
            x=self.x[t_idx],
            v=None if self.v is None else self.v[t_idx],
            h=self.h,
            t=None if self.t is None else np.atleast_1d(self.t[t_idx]),
            extras=dict(self.extras),
        )

    def cut(self, t_idx: TimeIndex) -> None:
        """In-place time restriction (trajdata.py:92-98)."""
        x = self.x[t_idx]
        self.x = x[None] if x.ndim == 2 else x
        if self.v is not None:
            v = self.v[t_idx]
            self.v = v[None] if v.ndim == 2 else v
        if self.t is not None:
            self.t = np.atleast_1d(self.t[t_idx])

    def roll(
        self,
        next_x: Optional[np.ndarray] = None,
        next_v: Optional[np.ndarray] = None,
        next_t: Optional[np.ndarray] = None,
    ) -> None:
        """Advance the window: drop the oldest ``len(next_*)`` frames and append
        the new ones — the autoregressive-rollout primitive (trajdata.py:100-110)."""
        if next_x is not None:
            next_x = np.asarray(next_x)
            self.x = np.concatenate((self.x[next_x.shape[0] :], next_x), axis=0)
        if next_v is not None:
            next_v = np.asarray(next_v)
            self.v = np.concatenate((self.v[next_v.shape[0] :], next_v), axis=0)
        if next_t is not None:
            next_t = np.atleast_1d(np.asarray(next_t))
            self.t = np.concatenate((self.t[next_t.shape[0] :], next_t), axis=0)

    def snapshot(
        self,
        reduce_x: Optional[str] = "last",
        reduce_v: Optional[str] = "last",
        reduce_t: Optional[str] = "last",
    ) -> Dict[str, Optional[np.ndarray]]:
        """Collapse the time axis → flat dict (trajdata.py:112-140).

        'last' keeps the final frame; 'concat' flattens time into the feature
        axis [N, T*3]; anything else keeps the full array.
        """

        def reduce(arr, how):
            if arr is None or how is None:
                return arr
            if how == "last":
                return arr[-1]
            if how == "concat":  # [T, N, 3] → [N, T*3]
                return np.moveaxis(arr, 0, 1).reshape(arr.shape[1], -1)
            return arr

        out = {
            "x": reduce(self.x, reduce_x),
            "v": reduce(self.v, reduce_v),
            "t": None if self.t is None else (self.t[-1] if reduce_t == "last" else self.t),
            "h": self.h,
        }
        out.update(self.extras)
        return out


def fully_connected_edges(num_nodes: int) -> np.ndarray:
    """edge_index [2, N(N-1)] — fully connected minus self loops, row-major
    (i, j) ordering exactly as the reference builds it (nbody.py:108-119)."""
    row = np.repeat(np.arange(num_nodes), num_nodes)
    col = np.tile(np.arange(num_nodes), num_nodes)
    keep = row != col
    return np.stack([row[keep], col[keep]], axis=0).astype(np.int64)


def nbody_edge_attr(
    name: str,
    edge_index: np.ndarray,
    charges: np.ndarray,
    springs: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-edge interaction strength [M, 1] (nbody.py:120-131): spring
    connectivity for 'spring' systems, zeros for 'gravity', charge products
    otherwise."""
    if "spring" in name:
        assert springs is not None, "spring systems need the springs matrix"
        return springs[edge_index[0], edge_index[1]].reshape(-1, 1).astype(np.float32)
    if "gravity" in name:
        return np.zeros((edge_index.shape[1], 1), dtype=np.float32)
    c = charges.reshape(-1)
    return (c[edge_index[0]] * c[edge_index[1]]).reshape(-1, 1).astype(np.float32)


def _simulate_synthetic(name: str, n_traj: int, n_frames: int, n_nodes: int, seed: int = 0):
    """Deterministic leapfrog n-body stand-in for the GeoTDM datagen files."""
    rng = np.random.default_rng(stable_seed(name, n_nodes, seed))
    loc = np.empty((n_traj, n_frames, n_nodes, 3), np.float32)
    vel = np.empty_like(loc)
    charges = rng.choice([-1.0, 1.0], size=(n_traj, n_nodes, 1)).astype(np.float32)
    if "gravity" in name:
        edges = np.ones((n_traj, n_nodes, n_nodes), np.float32)
    else:
        edges = rng.integers(0, 2, size=(n_traj, n_nodes, n_nodes)).astype(np.float32)
        edges = np.triu(edges, 1)
        edges = edges + np.swapaxes(edges, 1, 2)
    dt = 0.01
    for i in range(n_traj):
        x = rng.standard_normal((n_nodes, 3)).astype(np.float32)
        v = 0.5 * rng.standard_normal((n_nodes, 3)).astype(np.float32)
        for f in range(n_frames):
            diff = x[:, None] - x[None, :]  # [N, N, 3]
            if "gravity" in name:
                r2 = (diff**2).sum(-1) + 0.5  # softening
                a = -(diff / r2[..., None] ** 1.5).sum(1)
            elif "spring" in name:
                a = -(edges[i][..., None] * diff).sum(1) * 0.5
            else:  # charged
                q = charges[i] @ charges[i].T  # [N, N]
                r2 = (diff**2).sum(-1) + 0.5
                a = (q[..., None] * diff / r2[..., None] ** 1.5).sum(1)
            v = v + dt * a
            x = x + dt * v
            loc[i, f], vel[i, f] = x, v
    return loc, vel, edges, charges


def load_nbody(
    root: Optional[str],
    name: str,
    suffix: str,
    synthetic_traj: int = 24,
    synthetic_frames: int = 60,
    synthetic_nodes: int = 5,
):
    """Load (loc [S,T,N,3], vel, springs [S,N,N], charges [S,N,1]).

    Mirrors NBody.preprocess_raw (nbody.py:49-85): charged/spring files store
    [S, T, 3, N] (transposed on load); gravity stores [S, T, N, 3] directly
    and replaces the edge matrix with all-ones. Falls back to a simulated
    system when the raw files are missing.
    """
    files = None
    if root is not None:
        files = [os.path.join(root, f"{k}_{suffix}.npy") for k in ("loc", "vel", "edges", "charges")]
    if files is not None and all(os.path.exists(f) for f in files):
        loc, vel, edges, charges = (np.load(f) for f in files)
        if "gravity" not in name:
            loc = np.swapaxes(loc, 2, 3)
            vel = np.swapaxes(vel, 2, 3)
        if "gravity" in name:
            edges = np.ones((loc.shape[0], loc.shape[2], loc.shape[2]), np.float32)
    else:
        loc, vel, edges, charges = _simulate_synthetic(
            name, synthetic_traj, synthetic_frames, synthetic_nodes
        )
    charges = np.asarray(charges, np.float32).reshape(loc.shape[0], loc.shape[2], 1)
    return (
        np.asarray(loc, np.float32),
        np.asarray(vel, np.float32),
        np.asarray(edges, np.float32),
        charges,
    )


@dataclass
class NBodyDataset(Dataset):
    """GeoTDM NBody systems (spring / gravity / charged) as framework samples.

    Port of geo_tdm/nbody.py:14-152: one sample per stored trajectory,
    optional observation noise (fixed noise matrix scaled by
    ``obs_noise_scale``, nbody.py:92-98,105-108), ``span`` truncation
    (nbody.py:133-135), mean-centering ``project`` (nbody.py:147-149),
    ``force_length`` cap and ``return_index`` system ids.
    """

    name: str = "spring_train"
    suffix: str = "train_springs5_initvel1"
    root: Optional[str] = None
    span: Optional[int] = 30
    force_length: Optional[int] = None
    return_index: bool = False
    obs_noise_scale: float = 0.0
    project: bool = False
    first_stage: bool = False
    include_edges: bool = True
    num_entities: int = 10
    seed: int = 0

    def __post_init__(self):
        self.loc, self.vel, self.springs, self.charges = load_nbody(
            self.root, self.name, self.suffix
        )
        n = self.loc.shape[2]
        if n > self.num_entities:
            raise ValueError(f"{n} bodies > num_entities {self.num_entities}")
        self.edge_index = fully_connected_edges(n)
        if self.obs_noise_scale > 0:
            noise_rng = np.random.default_rng(stable_seed(self.name, "noise"))
            self.noise = noise_rng.standard_normal(self.loc.shape).astype(np.float32)
        else:
            self.noise = None

    def __len__(self) -> int:
        n = self.loc.shape[0]
        return n if self.force_length is None else min(self.force_length, n)

    def trajectory(self, idx: int) -> Trajectory:
        """Full Trajectory view of system ``idx`` (edge payload in extras)."""
        extras = {}
        if self.include_edges:
            extras = {
                "edge_index": self.edge_index,
                "edge_attr": nbody_edge_attr(
                    self.name, self.edge_index, self.charges[idx], self.springs[idx]
                ),
            }
        if self.return_index:
            extras["system_id"] = np.asarray([idx], np.float32)
        x = self.loc[idx]
        if self.noise is not None:
            x = x + self.noise[idx] * self.obs_noise_scale
        if self.span is not None:
            x = x[: self.span]
        v = self.vel[idx][: self.span] if self.span is not None else self.vel[idx]
        if self.project:
            x = x - x.mean(axis=(0, 1), keepdims=True)
        return Trajectory(x=x, v=v, h=self.charges[idx], extras=extras)

    def sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        traj = self.trajectory(idx)
        n = traj.x.shape[1]
        entities = rng.permutation(self.num_entities)[:n].astype(np.int64)
        if self.first_stage:
            frame = int(rng.integers(0, traj.x.shape[0]))
            out = {
                "pos": traj.x[frame],
                "vel": traj.v[frame],
                "charge": traj.h.reshape(-1).astype(np.float32),
                "entities": entities,
            }
        else:
            t = traj.x.shape[0]
            out = {
                "pos": traj.x,
                "vel": traj.v,
                "charge": np.broadcast_to(
                    traj.h.reshape(-1).astype(np.float32), (t, n)
                ).copy(),
                "entities": np.broadcast_to(entities, (t, n)).copy(),
            }
        for k, v in traj.extras.items():
            out[k] = v
        return out
