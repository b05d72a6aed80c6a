"""The MoE FFN at serving time: routing and the glue around the expert kernels.

The serving half of ``apertis_llm_tpu/ops/moe.py`` (eval mode):

  * :func:`route`: router LayerNorm -> f32 logits -> softmax -> top-1 or
    top-2 by argmax passes (the first index wins a tie) -> weights
    renormalised by their sum + 1e-6. The routing losses are zero in eval;
  * :func:`moe_dense`: every expert on every token in float, combined by the
    routing weights. It is the tests' semantic yardstick, not on the card's
    path;
  * :func:`moe_dense_fat_kernel`: the glue of the combine-folded fat kernel
    (``ops/kernels/moe_ffn.py``), for small token counts;
  * :func:`moe_grouped_fat`: the counting-sort dispatch around the grouped
    kernel (``ops/kernels/moe_grouped.py``), for large token counts;
  * :func:`moe_dense_fused`: the glue of the per-expert kernel
    (``expert_ffn_dense``) over the per-expert stack, for small token counts
    under ``moe_mode="kernel"``;
  * :func:`moe_ragged`: the sort-based dispatch whose expert groups run
    their products one group at a time, for large token counts when the fat
    stack is int4 (the grouped kernel reads int8 stacks only) or when there
    is no fat stack (``moe_mode="kernel"``).

Both fat-stack kernels read the fat stack of ``models/moe_fuse.py`` (int8,
or int4 under w4a8 serving, :func:`fat_ffn`): the experts'
LayerNorm affines live in W1, so the glue applies one shared un-affine
LayerNorm and quantizes ``x - mean`` per row (the divide formula of
``ops/quant.py::quantize_rows``), folding the inverse standard deviation into
the row scale. ``combine @ b2`` is added outside the kernels in f32.

Training's dispatch (``moe_dispatch``, expert dropout, noisy routing and the
routing losses) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels.moe_ffn import (
    expert_ffn_dense, expert_ffn_fat, expert_ffn_fat_int4)
from apertis_llm_torch.ops.kernels.moe_grouped import TILE, expert_ffn_grouped
from apertis_llm_torch.ops.kernels.quant_matmul import quant_matmul_dyn_pre_q
from apertis_llm_torch.ops.norms import layer_norm
from apertis_llm_torch.ops.quant import quantize_rows

# One layer's fat stack: w1t_q, w1t_s, b1t, w2t_q, w2t_s, or for int4
# w1t_q4, w1t_sh, w1t_s, b1t, w2t_q4, w2t_sh, w2t_s.
FatStack = Dict[str, torch.Tensor]


class RouterOutput(NamedTuple):
    weights: torch.Tensor      # (S, K) renormalised combine weights, f32
    indices: torch.Tensor      # (S, K) expert ids, int64
    lb_loss: torch.Tensor      # scalar, 0 in eval
    rz_loss: torch.Tensor      # scalar, 0 in eval


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``exp(x - max) / sum`` over the last axis, as ``jax.nn.softmax``."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def route(x: torch.Tensor, router_ln_w: torch.Tensor, router_ln_b: torch.Tensor,
          router_w: torch.Tensor, router_b: torch.Tensor, top_k: int, *,
          layer_norm_eps: float) -> RouterOutput:
    """Eval-mode routing of tokens x (S, H) over ``router_w.shape[1]``
    experts (``ops/moe.py::route``)."""
    normed = layer_norm(x, router_ln_w, router_ln_b, eps=layer_norm_eps)
    logits = normed.float() @ router_w.float() + router_b.float()
    top_w, top_i = _top_k_gates(_softmax(logits), top_k)
    weights = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-6)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return RouterOutput(weights, top_i, zero, zero)


def _top_k_gates(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 or top-2 over the expert axis by argmax passes, the second
    masking the first winner with -inf, so that the first index wins a tie
    (the JAX package's order, for ``lax.top_k`` too). The port serves top-2
    only (``models/params.py::check_supported``)."""
    if k not in (1, 2):
        raise NotImplementedError(f"top-{k} routing is not ported (top-1 and top-2 are)")
    i1 = gates.argmax(dim=-1, keepdim=True)
    w1 = gates.gather(-1, i1)
    if k == 1:
        return w1, i1
    i2 = gates.scatter(-1, i1, float("-inf")).argmax(dim=-1, keepdim=True)
    w2 = gates.gather(-1, i2)
    return torch.cat([w1, w2], dim=-1), torch.cat([i1, i2], dim=-1)


def _combine_weights(routing: RouterOutput, num_experts: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """(S, E) combine matrix: the routing weight where an expert was chosen,
    else 0."""
    onehot = torch.nn.functional.one_hot(routing.indices, num_experts).to(dtype)
    return torch.einsum("ske,sk->se", onehot, routing.weights.to(dtype))


def _dequant(experts: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
    if key + "_q" in experts:
        return experts[key + "_q"].float() * experts[key + "_s"].float()
    return experts[key].float()


def moe_dense(x: torch.Tensor, routing: RouterOutput, experts: Dict[str, torch.Tensor],
              hidden_act: str, layer_norm_eps: float) -> torch.Tensor:
    """Every expert on every token in f32 (int8 stacks dequantized), combined
    with the routing weights: ``sum_e combine[s, e] * (act(LN_e(x) @ W1_e +
    b1_e) @ W2_e + b2_e)``."""
    act = get_activation(hidden_act)
    xf = x.float()
    w1, w2 = _dequant(experts, "w1"), _dequant(experts, "w2")
    outs = []
    for e in range(w1.shape[0]):
        xn = layer_norm(xf, experts["ln_w"][e], experts["ln_b"][e], eps=layer_norm_eps)
        hid = act(xn @ w1[e] + experts["b1"][e].float())
        outs.append(hid @ w2[e] + experts["b2"][e].float())
    combine = _combine_weights(routing, w1.shape[0], torch.float32)
    return torch.einsum("se,esh->sh", combine, torch.stack(outs)).to(x.dtype)


def center_quantize(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shared un-affine LayerNorm as int8 rows: ``x - mean`` quantized per
    row by ``quantize_rows``, with ``rsqrt(var + eps)`` (0 on constant rows)
    folded into the (S, 1) scale."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    cen = xf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    inv = torch.where(var > 0, torch.rsqrt(var + eps), torch.zeros_like(var))
    xq, xs = quantize_rows(cen)
    return xq, xs * inv


def fat_ffn(xq: torch.Tensor, xs: torch.Tensor, combine: torch.Tensor, fat: FatStack,
            num_experts: int, hidden_act: str) -> torch.Tensor:
    """The fat kernel of the stack's layout, int4 or int8: f32 (S, H) out,
    without ``combine @ b2``."""
    if "w1t_q4" in fat:
        return expert_ffn_fat_int4(xq, xs, combine, fat["w1t_q4"], fat["w1t_sh"], fat["w1t_s"],
                                   fat["b1t"], fat["w2t_q4"], fat["w2t_sh"], fat["w2t_s"],
                                   num_experts, hidden_act)
    return expert_ffn_fat(xq, xs, combine, fat["w1t_q"], fat["w1t_s"], fat["b1t"],
                          fat["w2t_q"], fat["w2t_s"], num_experts, hidden_act)


def moe_dense_fat_kernel(x: torch.Tensor, routing: RouterOutput, fat: FatStack,
                         b2: torch.Tensor, hidden_act: str,
                         layer_norm_eps: float) -> torch.Tensor:
    """Combine-folded all-expert FFN of tokens x (S, H) through
    :func:`fat_ffn`, plus ``combine @ b2`` in f32, cast to x's dtype
    (``ops/moe.py::moe_dense_fat_kernel``)."""
    xq, xs = center_quantize(x, layer_norm_eps)
    combine = _combine_weights(routing, b2.shape[0], torch.float32)
    out = fat_ffn(xq, xs, combine, fat, b2.shape[0], hidden_act)
    return (out + combine @ b2.float()).to(x.dtype)


def moe_dense_fused(x: torch.Tensor, routing: RouterOutput, fused: Dict[str, torch.Tensor],
                    b2: torch.Tensor, hidden_act: str, layer_norm_eps: float) -> torch.Tensor:
    """All-expert FFN of tokens x (S, H) through :func:`expert_ffn_dense` over
    the per-expert stack ``fused`` (``ops/moe.py::moe_dense_fused``): the
    centred quantization, the kernel's (E, S, H) in x's dtype, then
    ``einsum("se,esh->sh")`` with the combine weights in x's dtype."""
    num_experts = fused["b1f"].shape[0]
    xq, xs = center_quantize(x, layer_norm_eps)
    all_out = expert_ffn_dense(xq, xs, fused["w1f_q"], fused["w1f_s"], fused["b1f"],
                               fused["w2f_q"], fused["w2f_s"], b2.float(), x.dtype, hidden_act)
    combine = _combine_weights(routing, num_experts, x.dtype)
    return torch.einsum("se,esh->sh", combine, all_out)


def grouped_dispatch(indices: torch.Tensor, num_experts: int):
    """The counting sort of ``moe_grouped_fat``: token-major (token, choice)
    pairs go to rows ``dest`` of a (P, ·) matrix in which each expert's rows
    are contiguous and padded to whole TILE-row tiles, P = S*K + E*TILE.
    Returns ``(dest (S*K,), emap (P/TILE,) int32)``: ``emap[t]`` is the
    expert of tile t, and -1 for the tiles past the last expert's, which
    the kernel skips (the JAX package maps them to expert E-1 and computes
    them for nothing)."""
    flat_e = indices.reshape(-1)
    # Expert-major (E, S*K), so that the running count is a scan along the
    # innermost axis: on the card a scan along the outer axis of the
    # token-major one-hot took 0.7 ms a layer at 4096 rows.
    onehot = (torch.arange(num_experts, device=flat_e.device)[:, None] == flat_e[None, :]
              ).to(torch.int64)
    csum = torch.cumsum(onehot, dim=1)
    cnt = csum[:, -1]
    rank = (csum - onehot).gather(0, flat_e[None, :])[0]
    cnt_pad = (cnt + TILE - 1) // TILE * TILE
    ends = torch.cumsum(cnt_pad, dim=0)
    dest = (ends - cnt_pad)[flat_e] + rank
    p = flat_e.numel() + num_experts * TILE
    starts = torch.arange(p // TILE, device=flat_e.device) * TILE
    emap = torch.searchsorted(ends, starts, right=True).clamp(max=num_experts - 1)
    emap = torch.where(starts < ends[-1], emap, torch.full_like(emap, -1))
    return dest, emap.to(torch.int32)


def moe_grouped_fat(x: torch.Tensor, routing: RouterOutput, fat: FatStack,
                    b2: torch.Tensor, hidden_act: str,
                    layer_norm_eps: float) -> torch.Tensor:
    """Grouped MoE FFN of tokens x (S, H) through :func:`expert_ffn_grouped`
    (``ops/moe.py::moe_grouped_fat``): one centred quantization per token,
    each (token, choice) row placed at its expert-sorted slot, the kernel's
    bf16 rows gathered back and scaled by their routing weight in f32, the K
    choices summed, then ``+ combine @ b2``."""
    s, h = x.shape
    k = routing.indices.shape[1]
    num_experts = b2.shape[0]
    xq, xs = center_quantize(x, layer_norm_eps)
    dest, emap = grouped_dispatch(routing.indices, num_experts)
    p = emap.numel() * TILE
    # Token-major rows: row j of the repeat is token j // k.
    xq_pad = torch.zeros((p, h), dtype=torch.int8, device=x.device)
    xs_pad = torch.zeros((p, 1), dtype=torch.float32, device=x.device)
    xq_pad[dest] = xq.repeat_interleave(k, dim=0)
    xs_pad[dest] = xs.repeat_interleave(k, dim=0)
    y_pad = expert_ffn_grouped(xq_pad, xs_pad, emap, fat["w1t_q"], fat["w1t_s"], fat["b1t"],
                               fat["w2t_q"], fat["w2t_s"], num_experts, hidden_act)
    y = y_pad[dest].float() * routing.weights.reshape(-1, 1).float()
    combine = _combine_weights(routing, num_experts, torch.float32)
    out = y.reshape(s, k, h).sum(dim=1) + combine @ b2.float()
    return out.to(x.dtype)


def _maybe_dequant_experts(experts: Dict[str, torch.Tensor],
                           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Int8 expert stacks as weights of ``dtype``, ``w_q.to(dtype) *
    w_s.to(dtype)`` (``ops/moe.py::_maybe_dequant_experts``); float stacks
    as they are."""
    out = dict(experts)
    for key in ("w1", "w2"):
        if key + "_q" in out:
            out[key] = out.pop(key + "_q").to(dtype) * out.pop(key + "_s").to(dtype)
    return out


def moe_ragged(x: torch.Tensor, routing: RouterOutput, experts: Dict[str, torch.Tensor],
               hidden_act: str, layer_norm_eps: float,
               quant_matmul: str = "dyn") -> torch.Tensor:
    """Sort-based dispatch over the expert stacks (``ops/moe.py::moe_ragged``,
    eval): the (token, choice) pairs sorted by expert (stable), each row
    normed by its expert's LayerNorm, and each expert's contiguous row group
    multiplied by its own weights, one group at a time. Int8 experts take the
    JAX function's int8 branch under ``quant_matmul="dyn"``: quantized rows,
    both products through the w8a8 kernel with f32 out and no bias
    (``quant_matmul_dyn_pre_q``), ``+ b1``, the activation and the
    requantization of the hidden outside. In the other modes they are
    dequantized in x's dtype (``_maybe_dequant_experts``) and take the float
    branch, as float experts do. The rows are scaled by their routing weight
    in x's dtype and added back to their tokens. The group sizes are read on
    the host (one sync)."""
    if quant_matmul != "dyn":
        experts = _maybe_dequant_experts(experts, x.dtype)
    k = routing.indices.shape[1]
    num_experts = experts["ln_w"].shape[0]
    act = get_activation(hidden_act)
    flat_e = routing.indices.reshape(-1)                     # (S*K) token-major
    flat_w = routing.weights.reshape(-1).to(x.dtype)
    order = torch.argsort(flat_e, stable=True)
    tok = order // k
    e_sorted = flat_e[order]
    ends = torch.cumsum(torch.bincount(flat_e, minlength=num_experts), 0).tolist()
    groups = [(e, lo, hi) for e, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)) if hi > lo]
    xn = layer_norm(x[tok], experts["ln_w"][e_sorted], experts["ln_b"][e_sorted],
                    eps=layer_norm_eps)
    int8 = "w1_q" in experts

    def grouped(rows: torch.Tensor, name: str) -> torch.Tensor:
        """Each group's rows times its expert's weight ``name``."""
        if int8:
            r_q, r_s = quantize_rows(rows)
            out = rows.new_empty((rows.shape[0], experts[name + "_q"].shape[-1]),
                                 dtype=torch.float32)
            for e, lo, hi in groups:
                out[lo:hi] = quant_matmul_dyn_pre_q(r_q[lo:hi], r_s[lo:hi], experts[name + "_q"][e],
                                                    experts[name + "_s"][e], None, torch.float32)
            return out
        out = rows.new_empty((rows.shape[0], experts[name].shape[-1]))
        for e, lo, hi in groups:
            out[lo:hi] = rows[lo:hi] @ experts[name][e]
        return out

    hmid = act(grouped(xn, "w1") + experts["b1"][e_sorted])
    y = (grouped(hmid, "w2") + experts["b2"][e_sorted]).to(x.dtype)
    y = y * flat_w[order][:, None]
    return torch.zeros_like(x).index_add_(0, tok, y)
