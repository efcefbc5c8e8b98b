"""NBA SportVU multi-agent trajectories, copied from
``lam_slide_tpu/data/nba.py``.

Numpy port of src/datasets/nba.py: per-game ``.npz`` files (pos [F, 11, 2],
team [F, 11] in {0=ball, 1, 2}, group [F, 11], agent_id [F, 11]) from the
SocialVAE split, sliding windows of ``num_frames`` via cumulative sizes +
bisect (nba.py:129-143), team-flip + 2D rotation/translation augmentation
(nba.py:97-107). Stage 1 draws a random frame from a random game; stage 2
returns windows. Synthetic fallback: ball + 2×5 players with attracted
motion around a moving play focus. The whole-batch stage-2 path takes the
numpy forms of the batch-assembly primitives (the JAX package's C++ engine
waits for its own slice of the port), as ``MD17Dataset`` does.
"""

import os
from bisect import bisect_right
from dataclasses import dataclass
from itertools import accumulate
from typing import Dict, List, Optional

import numpy as np

from lam_slide_tpu_torch.data import batch_assembly as ba
from lam_slide_tpu_torch.data.augment import random_rotation_matrix_2d, rotate
from lam_slide_tpu_torch.data.loader import Dataset
from lam_slide_tpu_torch.utils.rng import stable_seed

SCENE_COND_INDICES = {"score": 0, "rebound": 1}


def _synthetic_game(scene: str, idx: int, n_frames: int = 64):
    rng = np.random.default_rng(stable_seed(scene, idx))
    n_agents = 11
    team = np.zeros((n_frames, n_agents), dtype=np.int64)
    team[:, 1:6] = 1
    team[:, 6:] = 2
    group = (team > 1).astype(np.int64)
    agent_id = np.broadcast_to(np.arange(n_agents), (n_frames, n_agents)).copy()

    focus = np.cumsum(rng.standard_normal((n_frames, 2)) * 0.8, axis=0) + [47.0, 25.0]
    offsets = rng.standard_normal((n_agents, 2)) * 8.0
    pos = focus[:, None] + offsets[None]
    pos += np.cumsum(rng.standard_normal((n_frames, n_agents, 2)) * 0.3, axis=0)
    return {
        "pos": pos.astype(np.float32),
        "team": team,
        "group": group,
        "agent_id": agent_id,
    }


def _holdout_is_test(name: str) -> bool:
    """Deterministic game-level holdout for single-directory layouts:
    ~20% of games by filename hash. Guarantees train/test disjointness
    when the data was not preprocessed into split subdirectories."""
    import zlib

    return zlib.crc32(name.encode()) % 5 == 0


def load_nba_games(
    root: Optional[str],
    scene: str,
    num_frames: int,
    shift,
    scale,
    max_files: Optional[int] = None,
    synthetic_games: int = 8,
    split: str = "train",
) -> List[Dict[str, np.ndarray]]:
    """Load one split of per-game npz files.

    Directory resolution (reference keeps separate SocialVAE train/test
    directories — NBADatamodule._create_dataloader passes
    ``data_dir/<scene>/<mode>``, nba.py:199-205):

    * ``root/<split>`` exists → that directory IS the split.
    * ``root`` is a flat game directory → deterministic filename-hash
      holdout (~20% test) so train and test game sets stay disjoint.
    * no files → synthetic games, with split-offset seeds (train draws
      game indices [0, n), test [100000, 100000 + n)) — disjoint by
      construction.
    """
    assert split in ("train", "test")
    games = []
    game_dir = None
    if root is not None:
        sub = os.path.join(root, split)
        if os.path.isdir(sub):
            game_dir = sub
            keep = lambda name: True
        elif os.path.isdir(root):
            game_dir = root
            keep = lambda name: _holdout_is_test(name) == (split == "test")
    if game_dir is not None:
        files = [f for f in sorted(os.listdir(game_dir)) if keep(f)]
        if max_files:
            files = files[:max_files]
        for name in files:
            data = dict(np.load(os.path.join(game_dir, name)))
            if data["pos"].shape[0] < num_frames:
                continue  # nba.py:84-86
            games.append(
                {
                    "pos": ((data["pos"] - shift) / scale).astype(np.float32),
                    "team": data["team"].astype(np.int64),
                    "group": data["group"].astype(np.int64),
                    "agent_id": data["agent_id"].astype(np.int64),
                }
            )
    if not games:
        offset = 0 if split == "train" else 100_000
        for i in range(synthetic_games):
            g = _synthetic_game(scene, offset + i)
            g["pos"] = ((g["pos"] - shift) / scale).astype(np.float32)
            games.append(g)
    return games


@dataclass
class NBADataset(Dataset):
    scene: str
    root: Optional[str] = None
    first_stage: bool = True
    num_frames: int = 20
    flip: bool = False
    rand_rotation: bool = False
    rand_translation: float = 0.0
    shift: float = 0.0
    scale: float = 1.0
    num_entities: int = 11
    max_files: Optional[int] = None
    synthetic_games: int = 8
    split: str = "train"

    def __post_init__(self):
        self.games = load_nba_games(
            self.root, self.scene, self.num_frames, np.asarray(self.shift),
            np.asarray(self.scale), self.max_files, self.synthetic_games,
            split=self.split,
        )
        valid = [0] + [g["pos"].shape[0] - self.num_frames + 1 for g in self.games]
        self.cumulative_sizes = list(accumulate(valid))
        self.cond_index = np.int64(SCENE_COND_INDICES[self.scene])
        if not self.first_stage:
            # whole-batch fast path picked up by the Loader (batch_assembly):
            # one gather/pad/augment pass per output array instead of
            # per-sample numpy + stack
            self._cum = np.asarray(self.cumulative_sizes, np.int64)
            self._game_n = np.asarray([g["pos"].shape[1] for g in self.games], np.int64)
            self.sample_batch = self._sample_batch_temporal

    def __len__(self) -> int:
        if self.first_stage:
            return len(self.games)
        return self.cumulative_sizes[-1]

    def _augment(self, pos, team, rng: np.random.Generator):
        if self.flip and rng.random() < 0.5:
            team = team.copy()
            m1, m2 = team == 1, team == 2  # nba.py:99-102 team swap
            team[m1] = 2
            team[m2] = 1
        if self.rand_rotation:
            pos = rotate(pos, random_rotation_matrix_2d(rng))
        if self.rand_translation:
            pos = pos + (rng.standard_normal(2) * self.rand_translation).astype(np.float32)
        return pos.astype(np.float32), team

    def sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.first_stage:
            game = self.games[int(rng.integers(len(self.games)))]
            f = int(rng.integers(game["pos"].shape[0]))
            pos, team = self._augment(game["pos"][f], game["team"][f], rng)
            n = pos.shape[0]
            entities = rng.permutation(self.num_entities)[:n].astype(np.int64)
            return {
                "pos": pos,
                "team": team,
                "group": game["group"][f],
                "agent_id": game["agent_id"][f],
                "entities": entities,
            }
        g = bisect_right(self.cumulative_sizes, idx)
        game = self.games[g - 1]
        start = idx - self.cumulative_sizes[g - 1]
        sl = slice(start, start + self.num_frames)
        pos, team = self._augment(game["pos"][sl], game["team"][sl], rng)
        n = pos.shape[1]
        entities = rng.permutation(self.num_entities)[:n].astype(np.int64)
        return {
            "pos": pos,
            "team": team,
            "group": game["group"][sl],
            "agent_id": game["agent_id"][sl],
            "entities": np.broadcast_to(entities, (self.num_frames, n)).copy(),
            "cond_scene": self.cond_index,
        }

    def _sample_batch_temporal(self, idx_batch, rng: np.random.Generator):
        """Whole-batch stage-2 assembly — identical output format/semantics to
        sample() + pad_collate_temporal (pinned by tests); augmentations are
        drawn batched from the same distributions."""
        idxs = np.asarray(idx_batch, dtype=np.int64)
        b = len(idxs)
        t = self.num_frames
        n_pad = self.num_entities
        gi = np.searchsorted(self._cum, idxs, side="right") - 1
        starts = idxs - self._cum[gi]
        n_real = self._game_n[gi]
        games = [self.games[g] for g in gi]
        pos = ba.gather_pad_f32([g["pos"] for g in games], starts, t, n_pad)
        team, group, agent_id = (ba.gather_pad_i64([g[k] for g in games], starts, t, n_pad)
                                 for k in ("team", "group", "agent_id"))

        if self.flip:
            ba.team_flip(team, rng.random(b) < 0.5)
        rots = None
        if self.rand_rotation:
            theta = 2 * np.pi * rng.random(b)
            c, s = np.cos(theta, dtype=np.float32), np.sin(theta, dtype=np.float32)
            rots = np.stack(
                [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1
            )  # [B, 2, 2]
        trans = (
            (rng.standard_normal((b, 2)) * self.rand_translation).astype(np.float32)
            if self.rand_translation
            else None
        )
        if rots is not None or trans is not None:
            ba.rotate_batch(pos, rots, trans, n_real=n_real)

        perms = ba.permutations_batch(rng, b, n_pad, n_pad)
        entities = ba.broadcast_pad_rows(perms, n_real, t, n_pad)
        return {
            "pos": pos,
            "team": team,
            "group": group,
            "agent_id": agent_id,
            "entities": entities,
            "cond_scene": np.full((b,), self.cond_index, np.int64),
            "attention_mask": ba.attention_mask(n_real, t, n_pad),
        }
