"""Sequence parallelism for the selective-SSM mixer
(``apertis_llm_tpu/parallel/sequence.py``).

The linear recurrence composes across sequence chunks: each rank scans its
own chunk of L from zero and from one (its cumulative decay), the ranks
exchange the (B, H, N) chunk summaries with one all-gather each over the
``seq`` group, and a fold over the chunks before this rank gives its
incoming state. For chunk c with zero-state scan h0[t] and cumulative decay
A[t] = prod_{s<=t} a[s]:

    h[t]    = h0[t] + A[t] * h_in(c)
    h_in(c) = fold over chunks d < c of  h <- P(d) * h + S(d)

with P(d), S(d) chunk d's total decay and final zero-state state. The depthwise
causal conv needs the previous chunk's last K-1 inputs, which
:func:`previous_rows` brings over the same group.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apertis_llm_torch.ops.ssm import selective_scan
from apertis_llm_torch.parallel.collectives import all_gather
from apertis_llm_torch.parallel.mesh import Mesh


def ssm_scan_sequence_parallel(
    a_bar: torch.Tensor,    # (B, H, L / seq, N): this rank's chunk
    b_term: torch.Tensor,
    mesh: Mesh,
    axis: str = "seq",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contract of ``ops/ssm.py::selective_scan`` over the sequence split
    along ``axis``: ``(h, h_last)`` with ``h`` this rank's chunk of the
    states and ``h_last`` the final state of the whole sequence, the same on
    every rank. Two carried-state scans a call (kernel #2's forward, and its
    backward in the gradient) and two all-gathers of (B, H, N) summaries.
    The fold selects with ``torch.where``, as the JAX body does, so that every
    summary is in every rank's graph and every rank runs the all-gathers'
    backward."""
    h0, s_last = selective_scan(a_bar, b_term)
    cum, p_last = selective_scan(a_bar, torch.zeros_like(b_term),
                                 h_init=torch.ones_like(a_bar[:, :, 0, :]))
    group = mesh.group(axis)
    p_all = all_gather(p_last, group)     # (seq, B, H, N)
    s_all = all_gather(s_last, group)
    idx = mesh.index(axis)
    h_in = h_total = torch.zeros_like(s_last)
    for c in range(p_all.shape[0]):
        combined = p_all[c] * h_total + s_all[c]
        # h_in freezes once the fold reaches this rank's own chunk.
        h_in = torch.where(combined.new_full((), c < idx, dtype=torch.bool), combined, h_in)
        h_total = combined
    return h0 + cum * h_in[:, :, None, :], h_total


def previous_rows(x: torch.Tensor, rows: int, mesh: Mesh, axis: str = "seq") -> torch.Tensor:
    """The last ``rows`` positions (B, rows, C) of the previous rank's chunk
    along ``axis``, zeros on the first rank: the halo of a causal conv with
    ``rows + 1`` taps (GSPMD exchanges it in the JAX package). One
    all-gather of every rank's tail; on the first rank the zeros are selected
    with ``torch.where`` so that it, too, runs the gather's backward."""
    if x.shape[1] < rows:
        raise ValueError(f"previous_rows: a chunk of {x.shape[1]} positions holds no {rows} rows")
    tails = all_gather(x[:, x.shape[1] - rows:, :], mesh.group(axis))
    idx = mesh.index(axis)
    prev = tails[(idx - 1) % tails.shape[0]]
    return torch.where(prev.new_full((), idx > 0, dtype=torch.bool), prev, torch.zeros_like(prev))
