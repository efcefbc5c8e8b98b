"""Autoregressive trajectory rollout sampling (counterpart of
``lam_slide_tpu/analysis/rollout.py``; reference ``SIAtom14SamplingWrapper``,
src/modules/sampling.py:16-100).

Build a T-frame batch from one conditioning frame (the frame broadcast over
time, the first frame visible through cond_idx=(0, 1)), sample the latent
ODE, decode, feed the final frame back as the next conditioning frame,
repeat. Each window is one ``SecondStage.make_sample_fn`` call on the
second stage's own modules and device; its noise comes from the caller's
``torch.Generator``, one draw a window, so a chain is reproducible from one
seed. The chain's state is a single [R, 14, 3] frame (or [B, R, 14, 3]).
"""

from typing import Optional

import numpy as np
import torch


class RolloutSampler:
    def __init__(self, second_stage, scale: float = 1.0, shift: float = 0.0,
                 sampling_method: str = "ODE", sampling_kwargs: Optional[dict] = None):
        self.ss = second_stage
        self.scale = scale
        self.shift = shift
        self.device = next(second_stage.first_stage.parameters()).device
        self._sample = second_stage.make_sample_fn(sampling_method=sampling_method,
                                                   sampling_kwargs=sampling_kwargs)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=self.device).to(dtype)

    def create_batch(self, pos: torch.Tensor, res: torch.Tensor, res_mask: torch.Tensor):
        """Conditioning frame(s) -> T-frame batch (sampling.py:24-42): one
        frame ([R, 14, 3]) or a stack of B frames ([B, R, 14, 3]), the
        batched form driving every test peptide through one solve."""
        if pos.dim() == 3:
            pos, res, res_mask = pos[None], res[None], res_mask[None]
        b, r = res.shape
        t = self.ss.num_timesteps
        pos = pos * res_mask[..., None]
        return {
            "atom14_pos": pos[:, None].expand(b, t, r, 14, 3),
            "aatype": res[:, None].expand(b, t, r),
            "attention_mask": torch.ones((b, t, r), dtype=torch.bool, device=pos.device),
            "entities": torch.arange(r, device=pos.device)[None, None].expand(b, t, r),
        }

    @torch.no_grad()
    def _chain(self, generator: torch.Generator, cond_pos, res, res_mask,
               num_rollouts: int) -> np.ndarray:
        """[B, R, 14, 3] conditioning frames -> [B, num_rollouts * T, R, 14, 3]
        in normalized units, the first frame the exact conditioning one."""
        cond_pos = (self._tensor(cond_pos) - self.shift) / self.scale
        res, res_mask = self._tensor(res, torch.long), self._tensor(res_mask)
        b, r = res.shape
        pos, chunks = cond_pos, []
        for _ in range(num_rollouts):
            out = self._sample(self.create_batch(pos, res, res_mask), generator=generator)
            pred = out["atom14_pos"].float().reshape(b, self.ss.num_timesteps, r, 14, 3)
            chunks.append(pred.cpu().numpy())
            pos = pred[:, -1]
        positions = np.concatenate(chunks, axis=1)
        positions[:, 0] = cond_pos.cpu().numpy()  # sampling.py:62 exact-cond first frame
        return positions * res_mask.cpu().numpy()[:, None, :, :, None]

    def sample_rollout(self, generator: torch.Generator, cond_pos, res, res_mask,
                       num_rollouts: int = 1) -> np.ndarray:
        """Chained rollouts (sampling.py:44-63): one peptide's conditioning
        frame [R, 14, 3] -> [num_rollouts * T, R, 14, 3] in data units."""
        positions = self._chain(generator, self._tensor(cond_pos)[None],
                                self._tensor(res, torch.long)[None],
                                self._tensor(res_mask)[None], num_rollouts)[0]
        return positions * self.scale + self.shift

    def sample_rollout_batched(self, generator: torch.Generator, cond_pos, res, res_mask,
                               num_rollouts: int = 1) -> np.ndarray:
        """Batched chained rollouts: [B, R, 14, 3] conditioning frames ->
        [B, num_rollouts * T, R, 14, 3]. The chain semantics of
        ``sample_rollout`` with all B peptides in one solve a window; a
        window's noise is one draw for the whole batch (B=1 reproduces
        ``sample_rollout``), so a peptide's noise depends on which peptides
        share its batch. The protocol is statistical (JSD over sampled
        ensembles): batch composition changes the draw, not the
        distribution."""
        positions = self._chain(generator, cond_pos, res, res_mask, num_rollouts)
        return positions * self.scale + self.shift
