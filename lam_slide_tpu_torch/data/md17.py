"""MD17 small-molecule MD trajectories (copied from
``lam_slide_tpu/data/md17.py``, which the port never imports).

Numpy port of the reference pipeline (src/datasets/geo_tdm/md17.py +
src/datasets/md17.py): raw ``.npz`` (keys R [T, N, 3], z [N]) → optional
H-strip → ×``down_sample_every`` downsampling → 0.6/0.2/0.2 chronological
split → strided windows of ``span`` frames (5000 train / 1000 eval samples).
The torch-geometric graph features (h/edge_index/edge_attr) are *not* built:
the model never consumes them (SURVEY.md §7 step 3).

Per-sample processing matches src/datasets/md17.py:78-119: random entity-ID
permutation, frame-0 centering, shift/scale normalization, random rotation
(+ optional translation); stage 1 picks one random frame, stage 2 returns
the whole window with time-broadcast atom/entity arrays.

When no raw file exists a deterministic synthetic molecular trajectory is
generated (harmonic bonds + thermal noise) so every test and smoke train
runs without the 2 GB MD17 download.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from lam_slide_tpu_torch.data import batch_assembly as ba
from lam_slide_tpu_torch.data.augment import (random_rotation_matrices,
                                              random_rotation_matrix, rotate)
from lam_slide_tpu_torch.data.loader import Dataset
from lam_slide_tpu_torch.utils.rng import stable_seed

MOLECULE_FILES = {
    "aspirin": "md17_aspirin.npz",
    "benzene": "md17_benzene2017.npz",
    "ethanol": "md17_ethanol.npz",
    "malonaldehyde": "md17_malonaldehyde.npz",
    "naphthalene": "md17_naphthalene.npz",
    "salicylic": "md17_salicylic.npz",
    "toluene": "md17_toluene.npz",
    "uracil": "md17_uracil.npz",
}

# Conditioning-class indices — must stay ordered (src/datasets/md17.py:15-24).
MOLECULE_COND_INDICES = {m: i for i, m in enumerate(MOLECULE_FILES)}

SPLIT_RATIO = (0.6, 0.2, 0.2)


def _synthetic_raw(molecule: str, n_frames: int = 4000, seed: int = 0):
    """Deterministic stand-in raw data shaped like an MD17 npz payload."""
    rng = np.random.default_rng(stable_seed(molecule, seed))
    n_atoms = {"benzene": 12, "ethanol": 9, "aspirin": 21, "uracil": 12}.get(molecule, 13)
    z = rng.integers(1, 9, size=n_atoms)
    base = rng.standard_normal((n_atoms, 3)).astype(np.float32) * 1.5
    t = np.arange(n_frames, dtype=np.float32)[:, None, None]
    modes = rng.standard_normal((3, n_atoms, 3)).astype(np.float32) * 0.1
    freqs = np.asarray([0.031, 0.057, 0.013], dtype=np.float32)
    pos = base[None] + sum(
        np.sin(t * f) * m[None] for f, m in zip(freqs, modes)
    ) + 0.02 * rng.standard_normal((n_frames, n_atoms, 3)).astype(np.float32)
    return pos.astype(np.float32), z


def load_md17_split(
    root: Optional[str],
    molecule: str,
    mode: str,
    span: int,
    with_h: bool = True,
    down_sample_every: int = 10,
    force_length: Optional[int] = None,
    synthetic_frames: int = 4000,
):
    """Load one (molecule, mode) split → (x [F, N, 3], z [N], windows, interval).

    Mirrors MD17Traj.preprocess_raw/postprocess (geo_tdm/md17.py:62-154):
    velocities drop the final frame, optional H-strip, downsample, split,
    stride windows so 5000/1000 samples cover the split.
    """
    assert mode in ("train", "val", "test")
    path = None if root is None else os.path.join(root, MOLECULE_FILES[molecule])
    if path is not None and os.path.exists(path):
        data = np.load(path)
        x = np.asarray(data["R"], dtype=np.float32)[:-1]  # last frame feeds velocity only
        z = np.asarray(data["z"])
    else:
        x, z = _synthetic_raw(molecule, n_frames=synthetic_frames)
    if not with_h:
        keep = z > 1
        x = x[:, keep]
        z = z[keep]

    x = x[::down_sample_every]
    n = x.shape[0]
    lo, hi = {
        "train": (0, SPLIT_RATIO[0]),
        "val": (SPLIT_RATIO[0], SPLIT_RATIO[0] + SPLIT_RATIO[1]),
        "test": (SPLIT_RATIO[0] + SPLIT_RATIO[1], 1.0),
    }[mode]
    x = x[int(n * lo) : int(n * hi)]

    max_windows = x.shape[0] - span + 1
    if max_windows < 1:
        raise ValueError(
            f"{molecule}/{mode}: {x.shape[0]} frames cannot fit a span-{span} window "
            f"(need more raw frames or a smaller span)"
        )
    num = 5000 if mode == "train" else 1000
    if force_length is not None:
        num = min(force_length, num)
    num = min(num, max_windows)
    interval = max_windows // num
    assert interval >= 1
    return x, z.astype(np.int64), num, interval


@dataclass
class MD17Dataset(Dataset):
    """Windowed MD17 samples with on-the-fly augmentation.

    first_stage=True → single random frame per window (pos [N, 3]);
    first_stage=False → whole window (pos [1*, span, N, 3] squeezed to
    [span, N, 3], atom/entities broadcast over time) for the temporal collate.
    """

    molecule: str
    mode: str
    span: int = 30
    root: Optional[str] = None
    first_stage: bool = True
    with_h: bool = True
    down_sample_every: int = 10
    force_length: Optional[int] = None
    rand_rotation: bool = True
    rand_translation: Optional[float] = None
    num_entities: int = 50
    scale: float = 1.0
    shift: float = 0.0
    synthetic_frames: int = 4000

    def __post_init__(self):
        self.x, self.z, self._num, self._interval = load_md17_split(
            self.root,
            self.molecule,
            self.mode,
            self.span,
            with_h=self.with_h,
            down_sample_every=self.down_sample_every,
            force_length=self.force_length,
            synthetic_frames=self.synthetic_frames,
        )
        self.cond_index = np.int64(MOLECULE_COND_INDICES[self.molecule])
        self.n_atoms = self.z.shape[0]
        if self.n_atoms > self.num_entities:
            raise ValueError(
                f"{self.molecule} has {self.n_atoms} atoms > num_entities {self.num_entities}"
            )
        if not self.first_stage:
            # whole-batch fast path picked up by the Loader (batch_assembly)
            self.x = np.ascontiguousarray(self.x, np.float32)
            self.sample_batch = self._sample_batch_temporal

    def __len__(self) -> int:
        return self._num

    def sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        start = idx * self._interval
        pos = self.x[start : start + self.span].copy()  # [span, N, 3]

        entities = rng.permutation(self.num_entities)[: self.n_atoms].astype(np.int64)

        # frame-0 centering (md17.py:103), then normalize + rotate/translate
        pos = pos - pos[0].mean(axis=0)[None, None]
        pos = (pos - self.shift) / self.scale
        if self.rand_rotation:
            pos = rotate(pos, random_rotation_matrix(rng))
        if self.rand_translation is not None:
            pos = pos + (rng.standard_normal(3) * self.rand_translation).astype(np.float32)
        pos = pos.astype(np.float32)

        if self.first_stage:
            frame = int(rng.integers(0, pos.shape[0]))
            return {
                "pos": pos[frame],
                "atom": self.z,
                "cond_molecule": self.cond_index,
                "entities": entities,
            }
        return {
            "pos": pos,
            "atom": np.broadcast_to(self.z, (self.span, self.n_atoms)).copy(),
            "cond_molecule": self.cond_index,
            "entities": np.broadcast_to(entities, (self.span, self.n_atoms)).copy(),
        }

    def _sample_batch_temporal(self, idx_batch, rng: np.random.Generator):
        """Whole-batch stage-2 assembly — same output as sample() +
        pad_collate_temporal (pinned by tests): gather windows, frame-0
        center over real atoms, shift/scale + rotation (+translation),
        broadcast atom/entity ids, exact mask."""
        idxs = np.asarray(idx_batch, dtype=np.int64)
        b = len(idxs)
        t, n, n_pad = self.span, self.n_atoms, self.num_entities
        starts = idxs * self._interval
        n_real = np.full((b,), n, np.int64)
        pos = ba.gather_pad_f32([self.x] * b, starts, t, n_pad)
        ba.center_frame0(pos, n_real)  # md17.py:103, before normalization
        rots = None
        if self.rand_rotation:
            rots = random_rotation_matrices(rng, b)
        trans = (
            (rng.standard_normal((b, 3)) * self.rand_translation).astype(np.float32)
            if self.rand_translation is not None
            else None
        )
        ba.rotate_batch(pos, rots, trans, shift=self.shift, scale=self.scale,
                        n_real=n_real)

        atom = ba.broadcast_pad_rows(
            np.broadcast_to(np.pad(self.z, (0, n_pad - n)), (b, n_pad)),
            np.full((b,), n), t, n_pad)
        perms = np.pad(ba.permutations_batch(rng, b, n_pad, n), ((0, 0), (0, n_pad - n)))
        entities = ba.broadcast_pad_rows(perms, np.full((b,), n), t, n_pad)
        return {
            "pos": pos,
            "atom": atom,
            "cond_molecule": np.full((b,), self.cond_index, np.int64),
            "entities": entities,
            "attention_mask": ba.attention_mask(n_real, t, n_pad),
        }
