"""The optimizer and the train and eval steps (``apertis_llm_tpu/training/
step.py``).

The optimizer is the JAX package's optax chain written out in plain torch,
each step of it as optax computes it, in f32 on the f32 master parameters:

  1. global-norm clipping: ``g / norm * max_norm`` unless ``norm < max_norm``
     (optax's rule);
  2. Adam with bias correction, eps outside the square root;
  3. decoupled weight decay on the parameters :func:`decay_mask` selects;
  4. times the one-cycle cosine schedule at the 0-based update count;
  5. times -1, added to the parameters.

Gradient accumulation is ``optax.MultiSteps``: the running mean of k
micro-gradients, one update every k micro-steps, the schedule counting
updates only. The step casts every float parameter to the compute dtype
(bf16) for the forward through ``torch.func.functional_call``, so the
gradients land on the f32 masters, as the JAX ``loss_fn`` does with
``jax.tree.map(astype)``.

On a mesh of more than one rank (``parallel/mesh.py``) each rank takes its
part of the global batch (:func:`shard_batch`: its ``data`` rows and its
``seq`` chunk), the step runs under the parallel context, each rank's loss
is its tokens' summed loss over the global batch's count of valid targets,
and the gradients of the f32 masters are summed over all ranks before
``optimizer.update``, so that every rank sees the global batch's loss,
gradients and norm, as the JAX step does under GSPMD.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from apertis_llm_torch.models.apertis import ApertisForCausalLM, fold_seed, token_nll
from apertis_llm_torch.models.convert import STACKED
from apertis_llm_torch.parallel.collectives import all_reduce_sum
from apertis_llm_torch.parallel.context import parallel_context
from apertis_llm_torch.parallel.mesh import Mesh

Batch = Dict[str, torch.Tensor]

# Leaf names never decayed (step.py:45-47): biases, norm scales, the SSM's
# A_log and D, the router's w_noise, and the ViT's CLS token, position
# embeddings and packed attention bias.
NO_DECAY = ("b", "scale", "ln_w", "ln_b", "A_log", "D", "w_noise", "cls_token",
            "pos_embed", "in_proj_b")


def decay_mask(model: ApertisForCausalLM) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name (``step.py::
    _decay_mask``): not when the name's last component is in
    :data:`NO_DECAY`, nor when the JAX tree's leaf has at most one axis. The
    JAX tree stacks per-layer tensors on a leading layer axis, the ViT's
    too, so a layer's LayerNorm weight ``w`` (H,) is a 2-D leaf there and is
    decayed (``vision.layers.N.ln1.w`` as well), while ``final_norm.w`` and
    the ViT's ``final_ln.w`` are not; ``conv.w`` (C, K) is decayed and
    ``A_log`` is not."""
    mask = {}
    for name, p in model.named_parameters():
        stacked = any(name.startswith(prefix) for prefix, _ in STACKED)
        stacked_ndim = p.ndim + (1 if stacked else 0)
        mask[name] = name.rsplit(".", 1)[-1] not in NO_DECAY and stacked_ndim > 1
    return mask


def make_schedule(learning_rate: float, total_steps: int,
                  pct_start: float = 0.1) -> Callable[[int], float]:
    """The hand-built two-phase cosine one-cycle schedule (step.py:68-80),
    evaluated in f32 as the JAX package evaluates it: a cosine ramp from
    ``lr / 25`` to ``lr`` over ``max(int(total * pct_start), 1)`` updates,
    then a cosine decay to ``lr / 25 / 1e4``."""
    total = max(total_steps, 1)
    warmup = max(int(total * pct_start), 1)
    initial = learning_rate / 25.0
    final = initial / 10000.0

    def schedule(count: int) -> float:
        c = torch.tensor(float(count), dtype=torch.float32)
        up = initial + (learning_rate - initial) * 0.5 * (
            1.0 - torch.cos(math.pi * torch.clamp(c, max=float(warmup)) / warmup))
        down_frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        down = final + (learning_rate - final) * 0.5 * (1.0 + torch.cos(math.pi * down_frac))
        return float(up if count < warmup else down)

    return schedule


class AdamW:
    """The optax chain of the module docstring over named f32 parameters,
    wrapped in ``MultiSteps`` when ``every_k > 1``. :meth:`update` takes one
    micro-step's gradients and changes the parameters in place on every
    k-th call. ``count`` is the number of updates so far."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float, max_grad_norm: float, decay: Dict[str, bool],
                 every_k: int = 1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.schedule = schedule
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.decay = decay
        self.every_k = max(1, every_k)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mini_step = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.acc = ({n: torch.zeros_like(p) for n, p in params.items()}
                    if self.every_k > 1 else None)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One micro-step; True when it updated the parameters."""
        if self.acc is not None:
            # MultiSteps' Welford mean: acc + (g - acc) / (n + 1).
            for n, g in grads.items():
                acc = self.acc[n]
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return False
            self.mini_step = 0
            grads = self.acc
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm      # a device flag: no host sync
        t = self.count + 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(1.0 - torch.pow(one * self.b1, t))
        bc2 = float(1.0 - torch.pow(one * self.b2, t))
        lr = self.schedule(self.count)
        for n, p in self.params.items():
            g = torch.where(keep, grads[n], grads[n] / norm * self.max_grad_norm)
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decay[n]:
                u = u + self.weight_decay * p
            p.sub_(u * lr)
        if self.acc is not None:
            for acc in self.acc.values():
                acc.zero_()
        self.count = t
        return True

    def state_dict(self) -> Dict[str, Any]:
        state = {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            state["acc"] = self.acc
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if mine is None:
                continue
            for n, t in state[name].items():
                mine[n].copy_(t)


def make_optimizer(
    params: Dict[str, torch.Tensor],
    decay: Dict[str, bool],
    learning_rate: float,
    total_steps: int,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    gradient_accumulation_steps: int = 1,
    pct_start: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[AdamW, Callable[[int], float]]:
    """``(optimizer, schedule)`` as ``step.py::make_optimizer`` builds them,
    over ``params`` (name -> f32 parameter) with the weight-decay mask
    ``decay`` (:func:`decay_mask`)."""
    schedule = make_schedule(learning_rate, total_steps, pct_start)
    return AdamW(params, schedule, weight_decay, max_grad_norm, decay,
                 gradient_accumulation_steps, b1, b2, eps), schedule


def _run_params(model: ApertisForCausalLM,
                compute_dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """Every float parameter in the compute dtype (differentiable casts of the
    f32 masters), or the masters themselves."""
    params = dict(model.named_parameters())
    if compute_dtype is None or compute_dtype == torch.float32:
        return params
    return {n: p.to(compute_dtype) if p.is_floating_point() else p for n, p in params.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, Any]:
    """This rank's part of a global batch (``input_ids``, ``labels``,
    optional ``attention_mask``, (B, L) each): its ``data`` rows and its
    ``seq`` chunk of ``input_ids`` and ``attention_mask``, and of
    ``targets``, the labels shifted on the global sequence (position t
    predicts label t + 1, so a chunk's last position takes the next chunk's
    first label; ignored after the last position), with ``num_targets``, the
    count of valid targets of the whole batch (at least one)."""
    ids = batch["input_ids"]
    b, l = ids.shape
    rows, cols = b // mesh.shape["data"], l // mesh.shape["seq"]
    r0, c0 = mesh.index("data") * rows, mesh.index("seq") * cols
    targets = np.full_like(batch["labels"], -100)
    targets[:, :-1] = batch["labels"][:, 1:]
    part = {k: batch[k][r0:r0 + rows, c0:c0 + cols] for k in ("input_ids", "attention_mask")
            if k in batch}
    part["targets"] = targets[r0:r0 + rows, c0:c0 + cols]
    part["num_targets"] = max(int((targets != -100).sum()), 1)
    return part


def loss_fn(model: ApertisForCausalLM, batch: Batch, seed: Optional[int],
            compute_dtype: Optional[torch.dtype] = None,
            training: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {loss, lb_loss, rz_loss})`` of the training forward on
    ``batch`` (``input_ids``, ``labels``, optional ``attention_mask`` and
    ``pixel_values``, the images of a multimodal model) with
    the parameters cast to ``compute_dtype`` (``step.py::loss_fn``): for a
    MoE model the loss includes the layers' summed load-balancing and router
    z-losses, which the metrics also report (zero for a dense model). A
    ``seed`` of None draws no dropout, routing noise or expert dropout, as
    the JAX ``loss_fn`` does with ``rng=None``.

    A rank's part of a global batch (:func:`shard_batch`, ``targets`` and
    ``num_targets`` in place of ``labels``; a dense model) gives its tokens'
    summed loss over ``num_targets``: the ranks' losses add up to the global
    batch's."""
    if "targets" in batch:
        logits = torch.func.functional_call(
            model, _run_params(model, compute_dtype), (batch["input_ids"],),
            dict(attention_mask=batch.get("attention_mask"), training=training, seed=seed))
        loss = token_nll(logits, batch["targets"])[0].sum() / batch["num_targets"]
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss.detach(), "lb_loss": zero, "rz_loss": zero}
    out = torch.func.functional_call(
        model, _run_params(model, compute_dtype), (batch["input_ids"],),
        dict(attention_mask=batch.get("attention_mask"), labels=batch["labels"],
             pixel_values=batch.get("pixel_values"), training=training, seed=seed))
    return out.loss, {"loss": out.loss.detach(), "lb_loss": out.lb_loss.detach(),
                      "rz_loss": out.rz_loss.detach()}


def _sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' partial metrics summed over the world (one all-reduce)."""
    stacked = torch.stack(list(metrics.values()))
    all_reduce_sum([stacked])
    return dict(zip(metrics, stacked.unbind()))


def reduce_gradients(grads: Dict[str, torch.Tensor]) -> None:
    """Sum the ranks' gradients over the world, in place."""
    all_reduce_sum(list(grads.values()))


def train_step(model: ApertisForCausalLM, optimizer: AdamW, batch: Batch, seed: int,
               compute_dtype: Optional[torch.dtype] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One micro-step (``step.py::make_train_step``): loss and gradients of
    the f32 masters, then ``optimizer.update``. Returns the metrics ``loss``,
    ``lb_loss``, ``rz_loss`` and ``grad_norm`` (of this micro-step's
    gradients) as device tensors: no host sync.

    With ``mesh`` (more than one rank) ``batch`` is this rank's part
    (:func:`shard_batch`): the forward and backward run under the parallel
    context, dropout draws from the step seed folded with the rank, and the
    gradients and metrics are summed over the world before the update."""
    params = optimizer.params
    if mesh is not None:
        seed = fold_seed(seed, mesh.rank)
        with parallel_context(mesh):
            loss, metrics = loss_fn(model, batch, seed, compute_dtype)
            grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    else:
        loss, metrics = loss_fn(model, batch, seed, compute_dtype)
        # A parameter the step did not read (a MoE router's w_noise when no
        # noise is drawn) gets a zero gradient, as jax.grad gives it.
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    grads = {n: g.float().contiguous() for n, g in zip(params, grads)}
    if mesh is not None:
        reduce_gradients(grads)
        metrics = _sum_metrics(metrics)
    metrics["grad_norm"] = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    optimizer.update(grads)
    return metrics


@torch.no_grad()
def eval_step(model: ApertisForCausalLM, batch: Batch,
              compute_dtype: Optional[torch.dtype] = None,
              mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The loss without dropout or remat (``step.py::make_eval_step``); with
    ``mesh``, of this rank's part of the batch, summed over the world."""
    if mesh is None:
        return {"loss": loss_fn(model, batch, None, compute_dtype, training=False)[0]}
    with parallel_context(mesh):
        loss, _ = loss_fn(model, batch, None, compute_dtype, training=False)
    return _sum_metrics({"loss": loss})
