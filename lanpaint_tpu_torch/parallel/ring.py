"""Ring attention over the "seq" axis of a mesh (sequence parallelism).

PyTorch counterpart of `lanpaint_tpu/parallel/ring.py`: blockwise ring
attention with a numerically stable online softmax (running max and
normaliser) in fp32.  Each rank holds one contiguous block of the sequence;
K/V blocks travel the ring to the next rank of the group by
`dist.batch_isend_irecv` while the local partial softmax accumulates.  The
arithmetic per head is the JAX package's (q pre-scaled, fp32 scores, the
output cast back to q's dtype).  Plain PyTorch, as the JAX package computes
it in jnp outside any Pallas kernel.

`ring_attention` takes the local blocks and a process group;
`seq_parallel_attention` takes global tensors and a mesh.  The Wan model
uses the first under `WanConfig(seq_axis=...)` (models/wan.py,
`zoo.build_wan_seq_parallel`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import all_gather, axis_index, axis_size, block

# The fp32 scores of one block are computed a group of heads at a time so
# that they stay under this many bytes (TI2V-5B's S = 7,920: 8 of 24 heads).
SCORE_BYTES = 2e9


def _pass(tensors, group):
    """Send `tensors` to the next rank of `group` and receive the previous
    rank's (the JAX package's ppermute j -> j + 1)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def ring_attention(q, k, v, group, sm_scale: Optional[float] = None):
    """Non-causal attention of this rank's queries over every rank's keys.

    q, k, v: (B, S_local, H, D), this rank's contiguous block of the
    sequence (rank order = sequence order).  Returns (B, S_local, H, D) in
    q's dtype.  A group of one makes no transfer; the last step's transfer,
    which the JAX package makes and throws away, is skipped."""
    n = dist.get_world_size(group)
    scale = (1.0 / math.sqrt(q.shape[-1])) if sm_scale is None else sm_scale
    qt = q.transpose(1, 2).float() * scale                  # (B, H, S, D)
    kv = [k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()]
    b, h, s, d = qt.shape
    o = qt.new_zeros((b, h, s, d))
    m = qt.new_full((b, h, s), -math.inf)
    l = qt.new_zeros((b, h, s))
    step = max(1, min(h, int(SCORE_BYTES // (4 * b * s * kv[0].shape[2]))))
    for i in range(n):
        kt, vt = (t.float() for t in kv)
        for j in range(0, h, step):
            heads = slice(j, j + step)
            sc = qt[:, heads] @ kt[:, heads].transpose(-1, -2)
            m_new = torch.maximum(m[:, heads], sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            del sc
            corr = torch.exp(m[:, heads] - m_new)
            l[:, heads] = l[:, heads] * corr + p.sum(dim=-1)
            o[:, heads] = o[:, heads] * corr[..., None] + p @ vt[:, heads]
            m[:, heads] = m_new
            del p
        if i < n - 1:
            kv = _pass(kv, group)
    o = o / l[..., None]
    return o.transpose(1, 2).to(q.dtype)


def seq_parallel_attention(mesh, q, k, v, sm_scale: Optional[float] = None,
                           axis_name: str = "seq"):
    """q, k, v global (B, S, H, D), the same on every rank: this rank keeps
    its batch rows ("data") and sequence block (`axis_name`), runs the ring
    over `axis_name`, and all-gathers the output over both axes."""
    rows = block(q.shape[0], axis_size(mesh, "data"), axis_index(mesh, "data"))
    seq = block(q.shape[1], axis_size(mesh, axis_name), axis_index(mesh, axis_name))
    out = ring_attention(*(t[rows, seq] for t in (q, k, v)), mesh.get_group(axis_name),
                         sm_scale)
    out = all_gather(out, mesh.get_group(axis_name), 1)
    return all_gather(out, mesh.get_group("data"), 0)
