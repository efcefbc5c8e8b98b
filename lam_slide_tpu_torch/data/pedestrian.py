"""Pedestrian ETH/UCY trajectories (EqMotion-preprocessed splits), copied
from ``lam_slide_tpu/data/pedestrian.py``.

Numpy port of the reference pipeline (src/datasets/geo_tdm/eth_new.py +
src/datasets/pedestrian.py): ``<scene>_data_{train,test}.npy`` holds padded
scenes ``[S, N_max, T, 2]`` with true agent counts in
``<scene>_num_{train,test}.npy``; 8 past + 12 future frames; per-sample 2D
rotation / vertical+horizontal flip / translation augmentation; random
entity IDs per scene. The reference reuses the test split as "val" for
comparability (pedestrian.py:198-204) — so do we.

A synthetic fallback generates scenes of constant-velocity walkers with
social noise when the npy files are absent. Note: the reference's stage-1
random frame pick draws the index from [0, N) instead of [0, T)
(pedestrian.py:97-99) — a bug we do not replicate; we draw from [0, T).
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from lam_slide_tpu_torch.data import batch_assembly as ba
from lam_slide_tpu_torch.data.augment import random_rotation_matrix_2d, rotate
from lam_slide_tpu_torch.data.loader import Dataset
from lam_slide_tpu_torch.utils.rng import stable_seed

SCENE_COND_INDICES = {"zara1": 0, "zara2": 1, "univ": 2, "hotel": 3, "eth": 4}


def _synthetic_scenes(scene: str, n_scenes: int, t: int, n_max: int, seed: int = 0):
    rng = np.random.default_rng(stable_seed(scene, seed))
    counts = rng.integers(2, n_max + 1, size=n_scenes)
    data = np.zeros((n_scenes, n_max, t, 2), dtype=np.float32)
    for s in range(n_scenes):
        n = counts[s]
        start = rng.standard_normal((n, 2)) * 3.0
        vel = rng.standard_normal((n, 2)) * 0.15
        steps = np.arange(t)[None, :, None]
        traj = start[:, None] + vel[:, None] * steps
        traj += 0.03 * rng.standard_normal((n, t, 2)).cumsum(axis=1)
        data[s, :n] = traj
    return data.astype(np.float32), counts.astype(np.int64)


def load_pedestrian_split(
    root: Optional[str],
    scene: str,
    phase: str,
    traj_scale: float = 1.0,
    synthetic_scenes: int = 64,
    n_frames: int = 20,
    n_max: int = 10,
):
    """→ (data [S, N_max, T, 2], counts [S]); phase in {train, test}."""
    assert phase in ("train", "test")
    if root is not None:
        dpath = os.path.join(root, f"{scene}_data_{phase}.npy")
        npath = os.path.join(root, f"{scene}_num_{phase}.npy")
        if os.path.exists(dpath):
            data = np.load(dpath).astype(np.float32) / traj_scale
            counts = np.load(npath).astype(np.int64)
            return data, counts
    # phase-keyed seed: synthetic train and test scenes are disjoint, like
    # the real EqMotion-preprocessed *_data_{train,test}.npy pairs
    data, counts = _synthetic_scenes(scene, synthetic_scenes, n_frames, n_max,
                                     seed=0 if phase == "train" else 1)
    return data / traj_scale, counts


@dataclass
class PedestrianDataset(Dataset):
    scene: str
    phase: str  # "train" | "test"
    root: Optional[str] = None
    first_stage: bool = True
    past_frames: int = 8
    future_frames: int = 12
    traj_scale: float = 1.0
    rand_rotation: bool = False
    rand_translation: Optional[float] = None
    flip_vertical: bool = False
    flip_horizontal: bool = False
    num_entities: int = 10
    shift: float = 0.0
    scale: float = 1.0
    synthetic_scenes: int = 64

    def __post_init__(self):
        t = self.past_frames + self.future_frames
        self.data, self.counts = load_pedestrian_split(
            self.root, self.scene, self.phase, self.traj_scale,
            synthetic_scenes=self.synthetic_scenes, n_frames=t,
            n_max=self.num_entities,
        )
        if self.data.shape[2] < t:
            raise ValueError(f"scene frames {self.data.shape[2]} < past+future {t}")
        self.n_frames = t
        self.cond_index = np.int64(SCENE_COND_INDICES[self.scene])
        if not self.first_stage:
            # whole-batch fast path picked up by the Loader: the split is one
            # dense [S, N_max, T, 2] array, so assembly is a fancy-index +
            # transpose + one rotate_batch call (flips compose into the
            # rotation as row sign scalings)
            self.sample_batch = self._sample_batch_temporal

    def __len__(self) -> int:
        return self.data.shape[0]

    def _augment(self, pos: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.rand_rotation:
            pos = rotate(pos, random_rotation_matrix_2d(rng))
        if self.flip_vertical and rng.random() < 0.5:
            pos = pos.copy()
            pos[..., 0] *= -1
        if self.flip_horizontal and rng.random() < 0.5:
            pos = pos.copy()
            pos[..., 1] *= -1
        if self.rand_translation is not None:
            pos = pos + (rng.standard_normal(2) * self.rand_translation).astype(np.float32)
        return pos

    def sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        n = int(self.counts[idx])
        pos = self.data[idx, :n, : self.n_frames]  # [N, T, 2]
        pos = np.transpose(pos, (1, 0, 2)).astype(np.float32)  # [T, N, 2]
        pos = (pos - self.shift) / self.scale
        pos = self._augment(pos, rng)
        entities = rng.permutation(self.num_entities)[:n].astype(np.int64)

        if self.first_stage:
            frame = int(rng.integers(0, self.n_frames))
            return {"pos": pos[frame], "cond_scene": self.cond_index, "entities": entities}
        return {
            "pos": pos,
            "cond_scene": self.cond_index,
            "entities": np.broadcast_to(entities, (self.n_frames, n)).copy(),
        }

    def _sample_batch_temporal(self, idx_batch, rng: np.random.Generator):
        """Whole-batch stage-2 assembly — identical output format/semantics to
        sample() + pad_collate_temporal (pinned by tests).

        The per-sample chain is (p - shift)/scale -> R -> flips -> +t; the
        flips are diagonal sign matrices, so D·(R p) + t folds into
        rotate_batch with R' = D R (rows sign-scaled) and t drawn after."""
        idxs = np.asarray(idx_batch, dtype=np.int64)
        b = len(idxs)
        t, n_pad = self.n_frames, self.num_entities
        n_real = self.counts[idxs].astype(np.int64)

        # [B, N_max, T, 2] -> [B, T, N_max, 2] contiguous; rows beyond the
        # true agent count are zeroed (raw files may carry junk there, and
        # the per-sample path pads with exact zeros)
        pos = np.ascontiguousarray(
            self.data[idxs, :, :t].transpose(0, 2, 1, 3), np.float32
        )
        pos *= (np.arange(n_pad)[None, :] < n_real[:, None])[:, None, :, None]

        rots = None
        if self.rand_rotation:
            theta = 2 * np.pi * rng.random(b)
            c, s = np.cos(theta, dtype=np.float32), np.sin(theta, dtype=np.float32)
            rots = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1)
        signs = np.ones((b, 2), np.float32)
        if self.flip_vertical:
            signs[:, 0] = np.where(rng.random(b) < 0.5, -1.0, 1.0)
        if self.flip_horizontal:
            signs[:, 1] = np.where(rng.random(b) < 0.5, -1.0, 1.0)
        if self.flip_vertical or self.flip_horizontal:
            if rots is None:
                rots = np.zeros((b, 2, 2), np.float32)
                rots[:, 0, 0] = signs[:, 0]
                rots[:, 1, 1] = signs[:, 1]
            else:
                rots = rots * signs[:, :, None]  # D @ R: scale rows
        trans = (
            (rng.standard_normal((b, 2)) * self.rand_translation).astype(np.float32)
            if self.rand_translation is not None
            else None
        )
        ba.rotate_batch(pos, rots, trans, shift=self.shift, scale=self.scale,
                        n_real=n_real)

        perms = ba.permutations_batch(rng, b, n_pad, n_pad)
        return {
            "pos": pos,
            "cond_scene": np.full((b,), self.cond_index, np.int64),
            "entities": ba.broadcast_pad_rows(perms, n_real, t, n_pad),
            "attention_mask": ba.attention_mask(n_real, t, n_pad),
        }
