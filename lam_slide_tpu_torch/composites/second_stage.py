"""Second stage: latent stochastic-interpolant diffusion over trajectories
(counterpart of ``lam_slide_tpu/composites/second_stage.py``; reference
lightning_base.py:167-263 and second_stage/md17.py).

Frames are encoded by the frozen stage-1 encoder into ``[B, T, L, D]``
latents; a LatentDiT generates the non-conditioning frames, conditioned
inpainting-style on frames ``[cond_idx0, cond_idx1)`` through a
conditioning tensor and a binary mask (``setup_conditioning``). The first
stage is frozen (``requires_grad_(False)``, the reference's ``freeze()``;
JAX keeps it in the state's constants): the encoder runs under
``torch.no_grad()`` (the JAX ``stop_gradient``), while the training loss's
aux terms decode the DiT's data prediction through it with the gradient
flowing back into that prediction (``make_loss``).

K-repeat sampling (``make_k_sample_fn``) encodes each batch once and
repeats the latents K times along the batch axis (encode draws nothing, so
this is the JAX program's result with K-1 fewer encodes), then solves
``k_chunk`` repeats at a time as one batch of ``k_chunk * B`` trajectories
and decodes every frame of the chunk in one call.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from lam_slide_tpu_torch.composites.first_stage import FirstStageBackbone
from lam_slide_tpu_torch.nn import initializers as inits
from lam_slide_tpu_torch.nn.losses import inter_distance, masked_mse, masked_norm
from lam_slide_tpu_torch.parallel import rows as batch_rows
from lam_slide_tpu_torch.transport import Sampler, Transport


class ClassCondDiT(nn.Module):
    """LatentDiT + a class-embedding conditioning vector (CondWrapper,
    second_stage/md17.py:182-191: class id -> nn.Embedding -> y). Keys are the
    reference wrapper's: ``backbone.*`` for the DiT and
    ``vec_in_embedding.weight``."""

    def __init__(self, dit: nn.Module, n_classes: int, vec_in_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.backbone = dit
        self.vec_in_embedding = nn.Embedding(n_classes, vec_in_dim, _weight=inits.normal_(
            torch.empty(n_classes, vec_in_dim), gen, 1.0))

    def forward(self, x, t, x_cond, x_cond_mask, y_class=None):
        y = None
        if y_class is not None:
            y = self.vec_in_embedding(y_class.long().reshape(x.shape[0]))
        return self.backbone(x, t, x_cond, x_cond_mask, y)


def setup_conditioning(latents: torch.Tensor, cond_idx: Tuple[int, int],
                       mask_cond_mean: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conditioning tensor + mask (lightning_base.py:240-263): frames in
    [cond_idx0, cond_idx1) are visible; the rest hold the mean of the visible
    latents (``mask_cond_mean``) or zero."""
    b, t, l, _ = latents.shape
    frame_idx = torch.arange(t, device=latents.device)
    frame_mask = (frame_idx >= cond_idx[0]) & (frame_idx < cond_idx[1])
    x_cond_mask = frame_mask[None, :, None].expand(b, t, l).to(torch.int32)
    if mask_cond_mean:
        fill = latents[:, cond_idx[0]:cond_idx[1]].mean(dim=1, keepdim=True)
    else:
        fill = torch.zeros_like(latents[:, :1])
    x_cond = torch.where(x_cond_mask[..., None].bool(), latents, fill)
    return x_cond, x_cond_mask


@dataclass
class SecondStage:
    """Frozen stage 1 + DiT backbone + transport. ``backbone`` is a
    ``LatentDiT`` or a ``ClassCondDiT``; when ``class_conditional`` the batch
    carries class indices under ``cond_key``. ``num_timesteps`` is the
    window length T (the rollout sampler's). Construction freezes
    ``first_stage`` in place."""

    backbone: nn.Module
    transport: Transport
    first_stage: FirstStageBackbone
    cond_idx: Tuple[int, int] = (0, 10)
    mask_cond_mean: bool = True
    num_timesteps: int = 30
    class_conditional: bool = False
    cond_key: str = "cond_molecule"
    frame_keys: Tuple[str, ...] = ("pos", "atom", "attention_mask", "entities")

    def __post_init__(self):
        self.first_stage.requires_grad_(False)

    # -- stage-1 passthroughs (frozen) --------------------------------------

    @torch.no_grad()
    def encode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-frame encode with B T flattened (second_stage/md17.py:115-125)."""
        b = batch["entities"].shape[0]
        flat = {k: batch[k].flatten(0, 1) for k in self.frame_keys if k in batch}
        z = self.first_stage.encode(flat)
        return z.unflatten(0, (b, -1))

    def decode(self, latents: torch.Tensor, entities: torch.Tensor) -> Dict[str, torch.Tensor]:
        """latents [(B T), L, D] + entities [(B T), N] -> decoded heads. The
        stage-1 weights are frozen, so a graph is recorded only when the
        latents need a gradient (the aux losses); then the decoder's flash
        attention runs K1 with lse and K4 in fp32."""
        return self.first_stage.decode(latents, entities)

    # -- batch preparation ---------------------------------------------------

    def prepare_batch(self, batch: Dict[str, torch.Tensor]):
        """encode + conditioning -> (x1, model_kwargs) (lightning_base.py:205-215)."""
        latents = self.encode(batch)
        x_cond, x_cond_mask = setup_conditioning(latents, self.cond_idx, self.mask_cond_mean)
        model_kwargs = {"x_cond": x_cond, "x_cond_mask": x_cond_mask}
        if self.class_conditional:
            model_kwargs["y_class"] = batch[self.cond_key]
        return latents, model_kwargs

    def model_fn(self) -> Callable:
        return self.backbone

    # -- training loss ---------------------------------------------------------

    def make_loss(self, weight_si_loss: float = 1.0, weight_pos_loss: float = 0.0,
                  weight_inter_dist_loss: float = 0.0, calc_additional_losses: bool = False,
                  scale: float = 1.0):
        """loss_fn(model, batch, generator, train) for ``train.make_train_step``
        (second_stage.py:138-184): the SI loss of ``model`` (the backbone, or
        a call of it on other weights) on the encoded batch, t and x0 drawn
        from ``generator``; with ``calc_additional_losses`` also the position
        and inter-distance losses of the DATA-prediction latents decoded
        through the frozen first stage (second_stage/md17.py:220-257)."""

        def loss_fn(model, batch, generator, train):
            x1, model_kwargs = self.prepare_batch(batch)
            terms = self.transport.training_losses(model, x1, model_kwargs,
                                                   generator=generator)
            si_loss = terms["loss"].mean()
            total = weight_si_loss * si_loss
            metrics = {"si_loss": si_loss}
            if calc_additional_losses:
                pred = terms["pred"]
                pos_pred = self.decode(pred.flatten(0, 1),
                                       batch["entities"].flatten(0, 1))["pos"].float()
                pos_true = batch["pos"].flatten(0, 1)
                mask = batch["attention_mask"].flatten(0, 1)
                pos_loss = masked_mse(pos_pred, pos_true, mask)
                inter_loss = inter_distance(pos_pred, pos_true, mask)
                dist = masked_norm(pos_pred, pos_true, mask)
                total = total + weight_pos_loss * pos_loss + weight_inter_dist_loss * inter_loss
                metrics.update({"pos_loss": pos_loss, "inter_dist_loss": inter_loss,
                                "dist": dist * scale})
            return total, metrics

        return loss_fn

    # -- sampling --------------------------------------------------------------

    def _solver(self, sampling_method: str, sampling_kwargs: Optional[Dict[str, Any]]):
        return Sampler(self.transport).get_sample_fn(sampling_method, sampling_kwargs)

    def _decode_all(self, latents: torch.Tensor, entities: torch.Tensor):
        """[B', T, L, D] latents and [B', T, N] entities -> {name: [B', T, ...]}."""
        preds = self.decode(latents.flatten(0, 1), entities.flatten(0, 1))
        return {k: v.unflatten(0, latents.shape[:2]) for k, v in preds.items()}

    def make_sample_fn(self, sampling_method: str = "ODE",
                       sampling_kwargs: Optional[Dict[str, Any]] = None):
        """sample(batch, noise=None, generator=None) -> decoded dict of
        [B, T, ...] (lightning_base.py:217-238): noise init (drawn from
        ``generator`` unless given), integrate, decode all T frames."""
        solve = self._solver(sampling_method, sampling_kwargs)

        def sample(batch, noise=None, generator=None):
            x1, model_kwargs = self.prepare_batch(batch)
            if noise is None:
                noise = batch_rows.randn(x1.shape, generator, device=x1.device, dtype=x1.dtype)
            latents = solve(noise, self.model_fn(), **model_kwargs)
            return self._decode_all(latents, batch["entities"])

        return sample

    def make_k_sample_fn(self, k: int, k_chunk: Optional[int] = None,
                         sampling_method: str = "ODE",
                         sampling_kwargs: Optional[Dict[str, Any]] = None):
        """K-repeat sampling (the reference's ``for _ in range(K)`` loops,
        second_stage/md17.py:160): sample_k(batch, noise=None, generator=None)
        -> dict of [K, B, T, ...]. ``noise`` is [K, B, T, L, D] (drawn from
        ``generator`` unless given). ``k_chunk`` repeats run as one batch at a
        time (all K by default); it must divide k."""
        k_chunk = k if k_chunk is None or k_chunk >= k else k_chunk
        if k % k_chunk:
            raise ValueError(f"k_chunk {k_chunk} must divide k {k}")
        solve = self._solver(sampling_method, sampling_kwargs)

        def sample_k(batch, noise=None, generator=None):
            x1, model_kwargs = self.prepare_batch(batch)
            b = x1.shape[0]
            if noise is None:
                noise = batch_rows.randn((k, *x1.shape), generator, batch_dim=1,
                                   device=x1.device, dtype=x1.dtype)
            rep = {key: val.repeat(k_chunk, *([1] * (val.dim() - 1)))
                   for key, val in model_kwargs.items()}
            entities = batch["entities"].repeat(k_chunk, 1, 1)
            chunks = []
            for c in range(0, k, k_chunk):
                latents = solve(noise[c:c + k_chunk].flatten(0, 1), self.model_fn(), **rep)
                chunks.append(self._decode_all(latents, entities))
            return {key: torch.cat([ch[key] for ch in chunks]).unflatten(0, (k, b))
                    for key in chunks[0]}

        return sample_k
