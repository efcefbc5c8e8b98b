"""Ring attention: exact attention with the sequence axis split over a ring
of P chunks (counterpart of ``lam_slide_tpu/parallel/ring_attention.py``).

Each position of the ring holds a query chunk and, in turn, every K/V
chunk: per ring step it forms the chunk's softmax statistics and merges
them by JAX's running (m, l, acc) recurrence (ring_attention.py:78-88),
then passes its K/V chunk on. On the card a chunk's statistics are K1
with the lse (``ops.flash_attention.flash_attention_with_lse``: out and lse
give m = lse, l = 1, acc = out); on the CPU they are ``_chunk_stats``,
JAX's einsum form. The backward (JAX differentiates through ``ppermute``)
is an autograd Function: K4 (``flash_attention_backward``) on each chunk
with the merged output and lse, dQ summed where it is, dK/dV summed while
they travel the ring with their chunk, which one more step brings home.

The ring is an exchange function, so the same code runs

* over ranks: ``ring_attention(q, k, v, group)`` on each rank's local
  ``[B, H, T/P, D]`` shard, K/V moving by ``batch_isend_irecv`` to the next
  rank;
* in one process: ``ring_attention_chunks(qs, ks, vs)`` on a list of P
  chunks, K/V moving one place along the list (one card can hold the whole
  ring; two NCCL ranks cannot share it).
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lam_slide_tpu_torch.ops import flash_attention as fa

Exchange = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def _chunk_stats(q, k, v, scale):
    """Blockwise softmax statistics for one K/V chunk (JAX ``_chunk_stats``).

    q: [B, H, Tq, D]; k, v: [B, H, Tc, D] ->
    (m [B,H,Tq,1] fp32 rowmax, l [B,H,Tq,1] fp32 rowsum, acc [B,H,Tq,D] fp32).
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, l, acc


def _stats(q, k, v, scale):
    if q.device.type == "cpu":
        return _chunk_stats(q, k, v, scale)
    out, lse = fa.flash_attention_with_lse(q, k, v, scale)
    return lse.unsqueeze(-1), torch.ones_like(lse).unsqueeze(-1), out.float()


def _merge(carry, stats):
    m, l, acc = carry
    m_c, l_c, acc_c = stats
    m_new = torch.maximum(m, m_c)
    a = torch.exp(m - m_new)
    b = torch.exp(m_c - m_new)
    return m_new, l * a + l_c * b, acc * a + acc_c * b


def _forward(qs, ks, vs, scale, exchange: Exchange):
    """-> (outs, lses) of each ring position: out in q's dtype, lse
    [B, H, Tq] fp32."""
    n = len(qs)
    carry = [_stats(q, k, v, scale) for q, k, v in zip(qs, ks, vs)]
    for _ in range(1, _ring_size(exchange, n)):
        kv = exchange(list(ks) + list(vs))
        ks, vs = kv[:n], kv[n:]
        carry = [_merge(c, _stats(q, k, v, scale)) for c, q, k, v in zip(carry, qs, ks, vs)]
    outs = [(acc / torch.clamp(l, min=1e-30)).to(q.dtype) for (_, l, acc), q in zip(carry, qs)]
    lses = [(m + torch.log(l)).squeeze(-1).contiguous() for m, l, _ in carry]
    return outs, lses


def _backward(qs, ks, vs, outs, lses, gs, scale, exchange: Exchange):
    """-> (dqs, dks, dvs): each chunk's K4 grads against the merged out and
    lse; dK/dV ride the ring with their K/V chunk and come home after P
    steps."""
    n = len(qs)
    steps = _ring_size(exchange, n)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for step in range(steps):
        for i in range(n):
            dq, dk, dv = fa.flash_attention_backward(qs[i], ks[i], vs[i], outs[i], lses[i],
                                                     gs[i], scale)
            dqs[i] += dq.float()
            dks[i] += dk.float()
            dvs[i] += dv.float()
        if steps == 1:
            break
        if step < steps - 1:
            moved = exchange(list(ks) + list(vs) + dks + dvs)
            ks, vs, dks, dvs = moved[:n], moved[n:2 * n], moved[2 * n:3 * n], moved[3 * n:]
        else:
            moved = exchange(dks + dvs)
            dks, dvs = moved[:n], moved[n:]
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)], [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, exchange, n, *qkv):
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _forward(qs, ks, vs, scale, exchange)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.scale, ctx.exchange, ctx.n = scale, exchange, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        gs = [g.contiguous() for g in gs]
        dqs, dks, dvs = _backward(qs, ks, vs, outs, lses, gs, ctx.scale, ctx.exchange)
        return (None, None, None, *dqs, *dks, *dvs)


def _ring_size(exchange: Exchange, n: int) -> int:
    return getattr(exchange, "size", n)


def _in_process(p: int) -> Exchange:
    def exchange(tensors):
        out = []
        for g in range(0, len(tensors), p):
            grp = tensors[g:g + p]
            out += grp[-1:] + grp[:-1]
        return out

    exchange.size = p
    return exchange


def _over_group(group) -> Exchange:
    """The rank exchange: every tensor goes to the next rank of ``group``,
    and this rank's comes from the previous one (``batch_isend_irecv``)."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    nxt, prv = ((rank + 1) % size, (rank - 1) % size)
    if group is not None:
        nxt, prv = dist.get_global_rank(group, nxt), dist.get_global_rank(group, prv)

    def exchange(tensors):
        recv = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, r in zip(tensors, recv):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
            ops.append(dist.P2POp(dist.irecv, r, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    exchange.size = size
    return exchange


def _scale(q, scale):
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence axis sharded over the ranks of
    ``group`` (default: the world): q/k/v are this rank's LOCAL ``[B, H,
    T/P, D]`` shards of the global ``[B, H, T, D]``, rank r holding chunk r;
    returns the local output shard. Every rank of the group calls it."""
    exchange = _over_group(group)
    return _Ring.apply(_scale(q, scale), exchange, 1, q, k, v)[0]


def ring_attention_chunks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor],
                          scale: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """The ring over P chunks held by this process: ``qs[i]``, ``ks[i]``,
    ``vs[i]`` are chunk i of the sequence -> the P output chunks."""
    p = len(qs)
    return _Ring.apply(_scale(qs[0], scale), _in_process(p), p, *qs, *ks, *vs)


class _GatherSeq(torch.autograd.Function):
    """All-gather the ranks' sequence chunks (axis 2). Every rank goes on
    with the same global output, as an SPMD program does, so the gradient
    of this rank's chunk is its own slice of the output gradient (summing
    the ranks' copies would count the loss P times)."""

    @staticmethod
    def forward(ctx, out, group):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.contiguous(), group=group)
        ctx.size, ctx.rank = size, rank
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, 2)[ctx.rank], None


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                group=None, scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention on global ``[B, H, T, D]`` tensors, the same on every
    rank: split T into the group's P chunks, run the ring on this rank's,
    gather the output. A ring held by one process is
    ``ring_attention_chunks``."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    take = (lambda t: t.chunk(size, 2)[rank])
    return _GatherSeq.apply(ring_attention(take(q), take(k), take(v), group, scale), group)


def reference_attention(q, k, v, scale=None):
    """Single-device reference for parity tests."""
    return fa.reference_attention(q, k, v, scale)
