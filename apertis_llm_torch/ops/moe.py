"""The MoE FFN: routing, the float and training dispatches, and the glue
around the expert kernels (``apertis_llm_tpu/ops/moe.py``):

  * :func:`route`: router LayerNorm -> f32 logits (+ noise in training) ->
    softmax -> top-k by k argmax passes (the first index wins a tie)
    -> weights renormalised by their sum + 1e-6; in training the
    load-balancing and router z-losses, which are zero in eval;
  * :func:`expert_dropout_mask`: whole experts dropped for a training step;
  * :func:`moe_dispatch`: the capacity-bucketed dispatch of training;
  * :func:`moe_dense`: every expert on every token, combined by the routing
    weights, up to ``max(E, moe_dense_threshold_tokens)`` tokens when no
    serving stack is attached; int8 experts take its int8 branch (each
    expert's w8a8 products through the w8a8 kernel,
    ``quant_matmul_dyn_pre_q``) where ``quant_matmul`` resolves to ``dyn``
    (``ops/quant.py::resolve_mode``: under ``dyn`` only);
  * :func:`moe_ragged`: the sort-based dispatch whose expert groups run
    their products one group at a time, above that token count without the
    capacity limit, or when the attached fat stack is int4 (the grouped
    kernel reads int8 stacks only) or is not attached;
  * :func:`moe_dense_fat_kernel`: the glue of the combine-folded fat kernel
    (``ops/kernels/moe_ffn.py``), for small token counts;
  * :func:`moe_dense_fat`: the same fat stack's two products in plain torch
    (``moe_mode="fat"``, the JAX package's plain-XLA ``moe_dense_fat``),
    for small token counts;
  * :func:`moe_grouped_fat`: the counting-sort dispatch around the grouped
    kernel (``ops/kernels/moe_grouped.py``), for large token counts;
  * :func:`moe_dense_fused`: the glue of the per-expert kernel
    (``expert_ffn_dense``) over the per-expert stack, for small token counts
    under ``moe_mode="kernel"``.

The float dispatches (``moe_dispatch``, ``moe_dense``, ``moe_ragged``) run
in the tree's dtype, their expert products in plain torch, as the JAX
package leaves them to XLA; with the active mask of expert dropout where the
JAX functions apply it. Their token combines gather each (token, choice) row
and add a token's K rows in choice order, never by a scatter-add:
``index_add_`` on CUDA floats adds by atomics, whose order changes from run
to run, and a repeated training step must give the same result.

Both fat-stack kernels read the fat stack of ``models/moe_fuse.py`` (int8,
or int4 under w4a8 serving, :func:`fat_ffn`): the experts'
LayerNorm affines live in W1, so the glue applies one shared un-affine
LayerNorm and quantizes ``x - mean`` per row (the divide formula of
``ops/quant.py::quantize_rows``), folding the inverse standard deviation into
the row scale. ``combine @ b2`` is added outside the kernels in f32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from apertis_llm_torch.ops.activations import get_activation
from apertis_llm_torch.ops.kernels.moe_ffn import (
    expert_ffn_dense, expert_ffn_fat, expert_ffn_fat_int4)
from apertis_llm_torch.ops.kernels.moe_grouped import TILE, expert_ffn_grouped
from apertis_llm_torch.ops.kernels.quant_matmul import quant_matmul_dyn_pre_q
from apertis_llm_torch.ops.norms import layer_norm
from apertis_llm_torch.models.quantize import unpack_int4
from apertis_llm_torch.ops.quant import int_mm, quantize_rows, resolve_mode

# One layer's fat stack: w1t_q, w1t_s, b1t, w2t_q, w2t_s, or for int4
# w1t_q4, w1t_sh, w1t_s, b1t, w2t_q4, w2t_sh, w2t_s.
FatStack = Dict[str, torch.Tensor]


class RouterOutput(NamedTuple):
    weights: torch.Tensor      # (S, K) renormalised combine weights, f32
    indices: torch.Tensor      # (S, K) expert ids, int64
    lb_loss: torch.Tensor      # scalar f32, 0 in eval
    rz_loss: torch.Tensor      # scalar f32, 0 in eval


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``exp(x - max) / sum`` over the last axis, as ``jax.nn.softmax``."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def route(x: torch.Tensor, router_ln_w: torch.Tensor, router_ln_b: torch.Tensor,
          router_w: torch.Tensor, router_b: torch.Tensor, top_k: int, *,
          layer_norm_eps: float, training: bool = False,
          noise: Optional[torch.Tensor] = None, w_noise: Optional[torch.Tensor] = None,
          noisy_routing_alpha: float = 0.0, load_balancing_loss_coef: float = 0.0,
          router_z_loss_coef: float = 0.0, use_load_balancing_loss: bool = True,
          use_router_z_loss: bool = True) -> RouterOutput:
    """Routing of tokens x (S, H) over ``router_w.shape[1]`` experts
    (``ops/moe.py::route``); the logits are f32 whatever x's dtype. In
    training, ``noise`` (S, E), standard normal draws the caller makes, is
    added as ``noise * softplus(w_noise) * alpha`` when ``w_noise`` is given
    and alpha > 0; the load-balancing loss ``coef * E * sum_e f_e p_e`` (f_e
    the share of tokens that chose expert e, p_e its mean gate, both before
    any capacity) and the router z-loss ``coef * mean(logsumexp(logits)^2)``
    are computed where their switches are on and their coefficients
    positive."""
    num_experts = router_w.shape[-1]
    normed = layer_norm(x, router_ln_w, router_ln_b, eps=layer_norm_eps)
    logits = normed.float() @ router_w.float() + router_b.float()
    if training and w_noise is not None and noise is not None and noisy_routing_alpha > 0:
        wf = w_noise.float()
        scale = torch.logaddexp(wf, torch.zeros_like(wf)) * noisy_routing_alpha
        logits = logits + noise.float() * scale[None, :]
    gates = _softmax(logits)
    top_w, top_i = _top_k_gates(gates, top_k)
    lb_loss = rz_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if training and use_load_balancing_loss and load_balancing_loss_coef > 0:
        p_i = gates.mean(dim=0)
        sel = torch.nn.functional.one_hot(top_i, num_experts).float().sum(dim=1)
        f_i = torch.clamp(sel, max=1.0).mean(dim=0)      # 1 iff the expert is in the top-k
        lb_loss = load_balancing_loss_coef * num_experts * (f_i * p_i).sum()
    if training and use_router_z_loss and router_z_loss_coef > 0:
        rz_loss = router_z_loss_coef * torch.logsumexp(logits, dim=-1).square().mean()
    weights = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-6)
    return RouterOutput(weights, top_i, lb_loss, rz_loss)


def _top_k_gates(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the expert axis by k argmax passes, each masking the
    winners before it with -inf, so that the lowest index wins a tie and
    the choices come in descending order: the order of the JAX package's
    argmax passes (k <= 2) and of ``lax.top_k`` (any k)."""
    idx = []
    masked = gates
    for _ in range(k):
        i = masked.argmax(dim=-1, keepdim=True)
        idx.append(i)
        masked = masked.scatter(-1, i, float("-inf"))
    top_i = torch.cat(idx, dim=-1)
    return gates.gather(-1, top_i), top_i


def expert_dropout_mask(generator: torch.Generator, num_experts: int,
                        expert_dropout_prob: float) -> torch.Tensor:
    """(E,) bool on the generator's device: False for the ``int(E * p)``
    experts (at most E - 1) that lead a ``torch.randperm`` drawn from
    ``generator``, True for the rest (``ops/moe.py::expert_dropout_mask``)."""
    num_to_drop = min(int(num_experts * expert_dropout_prob), num_experts - 1)
    mask = torch.ones((num_experts,), dtype=torch.bool, device=generator.device)
    if num_to_drop <= 0:
        return mask
    perm = torch.randperm(num_experts, generator=generator, device=generator.device)
    return mask.index_fill(0, perm[:num_to_drop], False)


def _combine_weights(routing: RouterOutput, num_experts: int, dtype: torch.dtype,
                     active_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, E) combine matrix: the routing weight where an expert was chosen,
    else 0, times the active mask when one is given."""
    onehot = torch.nn.functional.one_hot(routing.indices, num_experts).to(dtype)
    combine = torch.einsum("ske,sk->se", onehot, routing.weights.to(dtype))
    if active_mask is not None:
        combine = combine * active_mask.to(dtype)[None, :]
    return combine


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


def _expert_norm(x: torch.Tensor, experts: Dict[str, torch.Tensor],
                 layer_norm_eps: float) -> torch.Tensor:
    """Rows x (E or 1, R, H) normed by each expert's LayerNorm: (E, R, H)."""
    return layer_norm(x, experts["ln_w"][:, None, :], experts["ln_b"][:, None, :],
                      eps=layer_norm_eps)


def _expert_mlp(xn: torch.Tensor, experts: Dict[str, torch.Tensor],
                hidden_act: str) -> torch.Tensor:
    """``act(xn @ w1 + b1) @ w2 + b2`` of each expert's normed rows xn
    (E, R, H), in xn's dtype (``ops/moe.py::_expert_mlp`` after its norm)."""
    hid = get_activation(hidden_act)(torch.matmul(xn, experts["w1"]) + experts["b1"][:, None, :])
    return torch.matmul(hid, experts["w2"]) + experts["b2"][:, None, :]


def _dyn_int8_batched(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """(E, S, K) @ (E, K, N) on per-(expert, row) int8 rows of x and the int8
    weights (``ops/moe.py::_dyn_int8_batched``), each expert's product
    through the w8a8 kernel: exact int32 sums, then ``acc * x_s * w_s`` in
    f32, out in x's dtype."""
    e, s, k = x.shape
    x_q, x_s = quantize_rows(x.reshape(e * s, k))
    x_q, x_s = x_q.reshape(e, s, k), x_s.reshape(e, s, 1)
    return torch.stack([quant_matmul_dyn_pre_q(x_q[i], x_s[i], w_q[i], w_s[i], None, x.dtype)
                        for i in range(e)])


def moe_dense(x: torch.Tensor, routing: RouterOutput, experts: Dict[str, torch.Tensor],
              hidden_act: str, layer_norm_eps: float,
              active_mask: Optional[torch.Tensor] = None,
              quant_matmul: str = "dyn") -> torch.Tensor:
    """Every expert on every token, combined with the routing weights (times
    the active mask): ``sum_e combine[s, e] * (act(LN_e(x) @ W1_e + b1_e) @
    W2_e + b2_e)`` in x's dtype (``ops/moe.py::moe_dense``). Int8 experts
    take the int8 branch (``_moe_dense_int8``) where ``quant_matmul``
    resolves to ``dyn``, as the JAX package's ``_use_dyn_int8`` mirrors
    ``_linear``'s rule, and are dequantized in x's dtype otherwise."""
    xn = _expert_norm(x[None], experts, layer_norm_eps)
    if (resolve_mode(quant_matmul) == "dyn" and "w1_q" in experts
            and "w2_q" in experts):
        act = get_activation(hidden_act)
        hid = act(_dyn_int8_batched(xn, experts["w1_q"], experts["w1_s"])
                  + experts["b1"][:, None, :])
        all_out = (_dyn_int8_batched(hid, experts["w2_q"], experts["w2_s"])
                   + experts["b2"][:, None, :])
    else:
        all_out = _expert_mlp(xn, _maybe_dequant_experts(experts, x.dtype), hidden_act)
    combine = _combine_weights(routing, all_out.shape[0], x.dtype, active_mask)
    return torch.einsum("se,esh->sh", combine, all_out)


def _add_choices(rows: torch.Tensor) -> torch.Tensor:
    """(S, H): each token's K rows of ``rows`` (S, K, H) added in choice
    order, in their dtype (``out.at[token].add`` without the atomics)."""
    out = rows[:, 0]
    for i in range(1, rows.shape[1]):
        out = out + rows[:, i]
    return out


def moe_dispatch(x: torch.Tensor, routing: RouterOutput, experts: Dict[str, torch.Tensor],
                 hidden_act: str, layer_norm_eps: float, capacity: int,
                 active_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The capacity-bucketed dispatch of training (``ops/moe.py::
    moe_dispatch``), in x's dtype. The (token, choice) pairs in k-major,
    token order (every token's first choice, then every second one) take
    the next slot of their expert's bucket of ``capacity`` rows: that order
    decides which pairs overflow. A pair past the capacity, or whose expert
    the active mask drops, contributes nothing. Each expert's MLP runs on
    its bucket as one batched product; each token adds its K choices' rows,
    scaled by their routing weights, in choice order.

    The buckets are filled by ``index_copy`` from each pair's slot: the kept
    slots are distinct, and every dropped pair goes to one spare row that is
    cut off. Gathering back, a dropped pair reads a zero row."""
    s, h = x.shape
    experts = _maybe_dequant_experts(experts, x.dtype)
    num_experts = experts["w1"].shape[0]
    k = routing.indices.shape[1]
    flat_idx = routing.indices.T.reshape(-1)                  # (K*S) k-major
    flat_w = routing.weights.T.reshape(-1)
    # Each pair's position in its expert's bucket: the running count of its
    # expert before it. Expert-major (E, K*S), so that the count is a scan
    # along the innermost axis (a scan along the outer axis of the pair-major
    # one-hot took 1.4 ms a call at 8192 pairs on the card).
    onehot = (torch.arange(num_experts, device=flat_idx.device)[:, None]
              == flat_idx[None, :]).to(torch.int64)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(0, flat_idx[None, :])[0]
    keep = pos < capacity
    if active_mask is not None:
        keep = keep & active_mask[flat_idx]
    spare = num_experts * capacity
    slot = torch.where(keep, flat_idx * capacity + pos, torch.full_like(pos, spare))
    buckets = x.new_zeros((spare + 1, h)).index_copy(0, slot, x.repeat(k, 1))
    xn = _expert_norm(buckets[:-1].reshape(num_experts, capacity, h), experts, layer_norm_eps)
    out_buckets = _expert_mlp(xn, experts, hidden_act).reshape(spare, h)
    # index_select, whose backward adds each kept pair's gradient to its own
    # bucket row (the kept slots are distinct; the dropped pairs add zeros to
    # the spare row), where indexing's backward sorts the indices first.
    gathered = torch.cat([out_buckets, out_buckets.new_zeros((1, h))]).index_select(0, slot)
    gathered = gathered * (flat_w * keep.to(flat_w.dtype))[:, None].to(x.dtype)
    return _add_choices(gathered.reshape(k, s, h).transpose(0, 1))


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


def moe_dense_fat(x: torch.Tensor, routing: RouterOutput, fat: FatStack, b2: torch.Tensor,
                  hidden_act: str, layer_norm_eps: float) -> torch.Tensor:
    """Combine-folded all-expert FFN of tokens x (S, H) as two plain 2-D
    int8 products over the fat stack (``ops/moe.py::moe_dense_fat``, the JAX
    package's ``APERTIS_MOE_FUSED=fat``): the centred quantization, ``acc1 =
    xq @ W1t`` in int32 (exact), ``hidden = act(acc1 * xs * w1t_s + b1t)``
    in f32, times each column's combine weight, requantized per row, ``acc2
    = hq @ W2t``, then ``acc2 * hs * w2t_s + combine @ b2`` in f32, cast to
    x's dtype. An int4 stack is unpacked to int8 first. No kernel: the
    products are :func:`int_mm`, as JAX leaves them to XLA."""
    num_experts = b2.shape[0]
    xq, xs = center_quantize(x, layer_norm_eps)
    if "w1t_q4" in fat:
        w1t = unpack_int4(fat["w1t_q4"], fat["w1t_sh"])
        w2t = unpack_int4(fat["w2t_q4"], fat["w2t_sh"])
    else:
        w1t, w2t = fat["w1t_q"], fat["w2t_q"]
    acc1 = int_mm(xq, w1t).float()
    hidden = get_activation(hidden_act)(acc1 * xs * fat["w1t_s"].float() + fat["b1t"].float())
    combine = _combine_weights(routing, num_experts, torch.float32)
    hidden = hidden * torch.repeat_interleave(combine, hidden.shape[1] // num_experts, dim=1)
    hq, hs = quantize_rows(hidden)
    acc2 = int_mm(hq, w2t).float()
    out = acc2 * hs * fat["w2t_s"].float() + combine @ b2.float()
    return out.to(x.dtype)


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


def moe_ragged(x: torch.Tensor, routing: RouterOutput, experts: Dict[str, torch.Tensor],
               hidden_act: str, layer_norm_eps: float, quant_matmul: str = "dyn",
               active_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort-based dispatch over the expert stacks (``ops/moe.py::moe_ragged``):
    the (token, choice) pairs sorted by expert (stable), each row normed by
    its expert's LayerNorm, and each expert's contiguous row group
    multiplied by its own weights, one group at a time (differentiable:
    training takes it above ``max(E, moe_dense_threshold_tokens)`` tokens
    without the capacity limit). Int8 experts take the JAX function's int8
    branch under ``quant_matmul="dyn"``: quantized rows, both products
    through the w8a8 kernel with f32 out and no bias
    (``quant_matmul_dyn_pre_q``), ``+ b1``, the activation and the
    requantization of the hidden outside. In the other modes they are
    dequantized in x's dtype (``_maybe_dequant_experts``) and take the float
    branch, as float experts do. The rows are scaled by their routing weight
    (times the active mask) in x's dtype, put back in token order and added
    per token in choice order. The group sizes are read on the host (one
    sync)."""
    if quant_matmul != "dyn":
        experts = _maybe_dequant_experts(experts, x.dtype)
    s, h = x.shape
    k = routing.indices.shape[1]
    num_experts = experts["ln_w"].shape[0]
    act = get_activation(hidden_act)
    flat_e = routing.indices.reshape(-1)                     # (S*K) token-major
    flat_w = routing.weights.reshape(-1).to(x.dtype)
    if active_mask is not None:
        flat_w = flat_w * active_mask[flat_e].to(flat_w.dtype)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    ends = torch.cumsum(torch.bincount(flat_e, minlength=num_experts), 0).tolist()
    groups = [(e, lo, hi) for e, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)) if hi > lo]
    xn = layer_norm(x.repeat_interleave(k, dim=0)[order], experts["ln_w"][e_sorted],
                    experts["ln_b"][e_sorted], eps=layer_norm_eps)
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
        return torch.cat([rows[lo:hi] @ experts[name][e] for e, lo, hi in groups])

    hmid = act(grouped(xn, "w1") + experts["b1"][e_sorted])
    y = (grouped(hmid, "w2") + experts["b2"][e_sorted]).to(x.dtype)
    y = y * flat_w[order][:, None]
    return _add_choices(y[torch.argsort(order)].reshape(s, k, h))
