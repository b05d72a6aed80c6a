"""The port's MoE training path and float MoE forward vs the JAX package's
(CPU, a 2-layer top-2-of-4 selective-SSM model, hidden 128).

One numpy f32 tree (perturbed off its 0/1 init) goes into both packages. The
JAX side runs ``forward`` and ``loss_fn`` on the raw tree, where its MoE FFN
is plain XLA: noisy routing with the load-balancing and router z-losses,
``moe_dispatch`` with capacity, ``moe_dense`` or ``moe_ragged`` in the tree's
dtype. The port runs the same functions with no serving stack attached. The
random draws of the two packages differ, so the comparisons pass JAX's own
noise into the port's ``route``, or give both the same active mask, or run
with no step seed (JAX's ``rng=None``: no noise and no expert dropout); the
port's own draws are held to their counts and to remat's rule instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (the JAX step's optimizer)

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models import apertis as jax_model
from apertis_llm_tpu.models.params import init_params as jax_init_params
from apertis_llm_tpu.models.quantize import quantize_params as jax_quantize_params
from apertis_llm_tpu.ops import moe as jax_moe
from apertis_llm_tpu.training import step as jax_step
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.ops import moe as torch_moe
from apertis_llm_torch.training import step as port_step

torch.set_num_threads(2)

MOE = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=8,
           intermediate_size=256, attention_type="selective_ssm", ssm_d_state=16,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=128, use_expert_system=True, num_experts=4,
           experts_per_token=2)
# f32 on both sides, as tests/test_torch_training.py states them: each
# gradient leaf within 1e-4 of its largest element, the losses to a relative
# 1e-5 (XLA's fused reductions and associative scan against the port's
# step-by-step sums).
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
# The float MoE forward's logits: the same f32 products, summed in other
# orders.
FORWARD_TOL = 1e-5


def _trees(seed, **over):
    """(JAX config, port config, perturbed numpy f32 tree)."""
    kw = dict(MOE, **over)
    jcfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), jcfg))
    tree["layers"]["ffn"]["w_noise"] = rng.normal(
        0.0, 0.5, tree["layers"]["ffn"]["w_noise"].shape).astype(np.float32)
    return jcfg, ApertisConfig(**kw), tree


def _batch(seed, b, l, vocab=97):
    ids = np.random.default_rng(seed).integers(4, vocab, (b, l)).astype(np.int32)
    labels = ids.copy()
    labels[:, -3:] = -100
    return {"input_ids": ids, "labels": labels}


def _close(got, ref, tol, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err:.3e} vs max {np.abs(ref).max():.3e}"


def _jax_leaf(tree, name):
    """The leaf of a stacked JAX tree for a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


def _routing_inputs(seed, s=40, h=128, e=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, h)).astype(np.float32)
    ln_w = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=h)).astype(np.float32)
    rw = (0.3 * rng.normal(size=(h, e))).astype(np.float32)
    rb = (0.1 * rng.normal(size=e)).astype(np.float32)
    w_noise = rng.normal(size=e).astype(np.float32)
    return x, ln_w, ln_b, rw, rb, w_noise


ROUTE_KW = dict(noisy_routing_alpha=0.7, load_balancing_loss_coef=0.01, router_z_loss_coef=0.001)


@pytest.mark.parametrize("threshold", [256, 8])
def test_float_moe_forward_matches_jax_without_an_engine(threshold):
    """A raw f32 tree's ``model(ids)`` (no engine, so no serving stack)
    against JAX ``forward()``: 3 x 16 tokens through ``moe_dense`` under the
    default threshold and ``moe_ragged`` under 8, the logits within 1e-5 of
    their largest value. No fat, grouped or per-expert kernel's plain
    version runs."""
    jcfg, cfg, tree = _trees(1, moe_dense_threshold_tokens=threshold)
    ids = _batch(2, 3, 16)["input_ids"]
    ref = np.asarray(jax_model.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                       jnp.asarray(ids)).logits)
    model = from_jax_params(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.long))
    _close(got.numpy(), ref, FORWARD_TOL, "logits")
    assert all(layer.ffn.experts.w1t_q is None and layer.ffn.experts.w1f_q is None
               for layer in model.layers)


def test_moe_dense_int8_branch_matches_jax(monkeypatch):
    """``moe_dense`` over int8 experts under ``quant_matmul="dyn"`` against
    JAX's under ``APERTIS_QUANT_MATMUL=dyn`` (``_moe_dense_int8``): both
    quantize each expert's normed rows and its hidden per row, with exact
    int32 sums. 40 tokens of one layer of a quantized tree
    (``quantize_params(min_size=0)``, bit-equal in both packages). Every
    int8 level agrees on these inputs, so the outputs differ only by f32
    sums taken in other orders: within 1e-5 of the largest. The other modes
    dequantize the experts: the f32 result, within 1e-5 too."""
    monkeypatch.setenv("APERTIS_QUANT_MATMUL", "dyn")
    _, _, tree = _trees(3)
    jq = jax_quantize_params(jax.tree.map(jnp.asarray, tree), min_size=0)
    tq = quantize_params(jax.tree.map(torch.from_numpy, tree), min_size=0)
    jexp = jax.tree.map(lambda v: v[0], jq["layers"]["ffn"]["experts"])
    texp = {k: v[0] for k, v in tq["layers"]["ffn"]["experts"].items()}
    assert "w1_q" in texp and "w1_q" in jexp
    x, ln_w, ln_b, rw, rb, _ = _routing_inputs(4)
    routing = jax_moe.route(*(jnp.asarray(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                            layer_norm_eps=1e-12)
    t_routing = torch_moe.route(*(torch.from_numpy(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                                layer_norm_eps=1e-12)
    ref = np.asarray(jax_moe.moe_dense(jnp.asarray(x), routing, jexp, "gelu", 1e-12))
    got = torch_moe.moe_dense(torch.from_numpy(x), t_routing, texp, "gelu", 1e-12,
                              quant_matmul="dyn")
    _close(got.numpy(), ref, FORWARD_TOL, "int8 branch")
    monkeypatch.delenv("APERTIS_QUANT_MATMUL")
    ref = np.asarray(jax_moe.moe_dense(jnp.asarray(x), routing, jexp, "gelu", 1e-12))
    got = torch_moe.moe_dense(torch.from_numpy(x), t_routing, texp, "gelu", 1e-12,
                              quant_matmul="weightonly")
    _close(got.numpy(), ref, FORWARD_TOL, "dequantized")


def test_route_training_form_matches_jax_with_its_noise():
    """``route(training=True)`` given JAX's own draw (``jax.random.normal``
    on the key JAX's route uses) as ``noise``: the same expert indices, the
    weights within 1e-6, the load-balancing and router z-losses and the
    gradients of the losses and weights with respect to x, the router and
    w_noise within 1e-5 of their largest values."""
    x, ln_w, ln_b, rw, rb, w_noise = _routing_inputs(5)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, (x.shape[0], rw.shape[1])))
    wts = np.random.default_rng(6).normal(size=(x.shape[0], 2)).astype(np.float32)

    def jax_obj(x_, rw_, wn_):
        r = jax_moe.route(x_, jnp.asarray(ln_w), jnp.asarray(ln_b), rw_, jnp.asarray(rb), 2,
                          layer_norm_eps=1e-12, training=True, noise_rng=key, w_noise=wn_,
                          **ROUTE_KW)
        return jnp.sum(r.weights * wts) + r.lb_loss + r.rz_loss, r

    (_, ref), jgrads = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(rw), jnp.asarray(w_noise))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, rw, w_noise)]
    got = torch_moe.route(leaves[0], torch.from_numpy(ln_w), torch.from_numpy(ln_b), leaves[1],
                          torch.from_numpy(rb), 2, layer_norm_eps=1e-12, training=True,
                          noise=torch.from_numpy(noise), w_noise=leaves[2], **ROUTE_KW)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.weights.detach().numpy(), np.asarray(ref.weights), atol=1e-6)
    for name in ("lb_loss", "rz_loss"):
        value = float(getattr(got, name).detach())
        assert value > 0
        np.testing.assert_allclose(value, float(getattr(ref, name)), rtol=1e-5)
    obj = (got.weights * torch.from_numpy(wts)).sum() + got.lb_loss + got.rz_loss
    for name, g, r in zip(("x", "router", "w_noise"), torch.autograd.grad(obj, leaves), jgrads):
        _close(g.numpy(), r, 1e-5, name)
    # Without noise, or in eval, the noise term is not added.
    plain = torch_moe.route(*(torch.from_numpy(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                            layer_norm_eps=1e-12)
    assert float(plain.lb_loss) == float(plain.rz_loss) == 0.0


@pytest.mark.parametrize("op", ["dispatch", "dense", "ragged"])
def test_active_mask_applies_where_jax_applies_it(op):
    """The three float dispatches with one active mask (expert 1 dropped):
    ``moe_dispatch`` with a capacity that drops pairs (k-major, token-order
    priority), ``moe_dense`` and ``moe_ragged``, against JAX's functions on
    the same f32 experts and routing, within 1e-5 of the largest output;
    and the gradients of x and the experts through the port's (the JAX
    functions are plain XLA, differentiated by ``jax.grad``), within 1e-4."""
    _, _, tree = _trees(7)
    experts = {k: v[0] for k, v in tree["layers"]["ffn"]["experts"].items()}
    x, ln_w, ln_b, rw, rb, _ = _routing_inputs(8, s=48)
    routing = jax_moe.route(*(jnp.asarray(a) for a in (x, ln_w, ln_b, rw, rb)), 2,
                            layer_norm_eps=1e-12)
    active = np.array([True, False, True, True])
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    capacity = 10            # 48 tokens x 2 choices over 4 experts: 24 a bucket on average
    counts = np.bincount(np.asarray(routing.indices).reshape(-1), minlength=4)
    assert op != "dispatch" or counts[active].max() > capacity

    def jax_fn(x_, ex):
        fn = {"dispatch": lambda: jax_moe.moe_dispatch(x_, routing, ex, "gelu", 1e-12, capacity,
                                                       jnp.asarray(active)),
              "dense": lambda: jax_moe.moe_dense(x_, routing, ex, "gelu", 1e-12,
                                                 jnp.asarray(active)),
              "ragged": lambda: jax_moe.moe_ragged(x_, routing, ex, "gelu", 1e-12,
                                                   jnp.asarray(active))}[op]
        out = fn()
        return jnp.sum(out * cot), out

    (_, ref), (gx, gex) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, experts))
    t_routing = torch_moe.RouterOutput(torch.from_numpy(np.asarray(routing.weights)),
                                       torch.from_numpy(np.asarray(routing.indices)).long(),
                                       None, None)
    xt = torch.tensor(x, requires_grad=True)
    ext = {k: torch.tensor(v, requires_grad=True) for k, v in experts.items()}
    mask = torch.from_numpy(active)
    if op == "dispatch":
        out = torch_moe.moe_dispatch(xt, t_routing, ext, "gelu", 1e-12, capacity, mask)
    elif op == "dense":
        out = torch_moe.moe_dense(xt, t_routing, ext, "gelu", 1e-12, mask)
    else:
        out = torch_moe.moe_ragged(xt, t_routing, ext, "gelu", 1e-12, "dyn", mask)
    _close(out.detach().numpy(), np.asarray(ref), FORWARD_TOL, op)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt, *ext.values()],
                                materialize_grads=True)
    _close(grads[0].numpy(), gx, GRAD_TOL, "dx")
    for (name, _), g in zip(ext.items(), grads[1:]):
        _close(g.numpy(), gex[name], GRAD_TOL, name)
    assert not grads[1 + list(ext).index("w1")][1].any()     # the dropped expert learns nothing


def test_expert_dropout_mask_drops_int_e_p_experts():
    """``int(E * p)`` experts dropped, at most E - 1, as JAX's mask; the
    permutation comes from the generator, so one seed gives one mask."""
    for e in (4, 8):
        for p in (0.0, 0.1, 0.3, 0.5, 0.99, 1.0):
            got = torch_moe.expert_dropout_mask(torch.Generator().manual_seed(3), e, p)
            ref = np.asarray(jax_moe.expert_dropout_mask(jax.random.PRNGKey(3), e, p))
            assert got.dtype == torch.bool and got.shape == (e,)
            assert int((~got).sum()) == int((~ref).sum()) == min(int(e * p), e - 1)
    a, b = (torch_moe.expert_dropout_mask(torch.Generator().manual_seed(s), 8, 0.5)
            for s in (1, 1))
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["capacity", "dense", "ragged"])
def test_moe_loss_and_gradients_match_jax(case):
    """The loss, ``lb_loss``, ``rz_loss`` and every parameter's gradient of a
    2-layer MoE model against JAX's ``loss_fn`` under ``training=True,
    rng=None`` (no noise, no expert dropout), f32: with the capacity limit
    at a factor of 0.5, where tokens overflow (``moe_dispatch``); without
    it under the default threshold (64 tokens: ``moe_dense``); and above a
    threshold of 8 (``moe_ragged``)."""
    over = {"capacity": dict(expert_capacity_factor=0.5),
            "dense": dict(use_expert_capacity_limit=False),
            "ragged": dict(use_expert_capacity_limit=False, moe_dense_threshold_tokens=8)}[case]
    jcfg, cfg, tree = _trees(10, **over)
    batch = _batch(11, 2, 32)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_step.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        None, None)
    model = from_jax_params(tree, cfg, device="cpu")
    params = dict(model.named_parameters())
    loss, metrics = port_step.loss_fn(model, {k: torch.as_tensor(v, dtype=torch.long)
                                              for k, v in batch.items()}, None)
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for name in ("lb_loss", "rz_loss"):
        assert float(metrics[name]) > 0
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=LOSS_RTOL)
    for name, g in zip(params, grads):
        _close(g.numpy(), _jax_leaf(jgrads, name), GRAD_TOL, name)


def test_remat_gives_equal_moe_gradients_with_noise_and_expert_dropout():
    """With routing noise and expert dropout live (a step seed, noise 0.5,
    half the experts dropped, capacity on), per-layer remat recomputes each
    layer with the draws of its first pass: remat on and off give equal
    gradients; another seed gives other ones, and w_noise gets a gradient."""
    _, cfg, tree = _trees(12, noisy_routing_alpha=0.5, expert_dropout_prob=0.5)
    model = from_jax_params(tree, cfg, device="cpu")
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in _batch(13, 2, 32).items()}
    params = dict(model.named_parameters())

    def grads(remat, seed):
        model.config = cfg.replace(remat=remat)
        loss, metrics = port_step.loss_fn(model, batch, seed)
        assert float(metrics["lb_loss"]) > 0 and float(metrics["rz_loss"]) > 0
        return torch.autograd.grad(loss, list(params.values()), materialize_grads=True)

    plain, remat, other = grads(False, 7), grads(True, 7), grads(True, 8)
    for name, a, b in zip(params, plain, remat):
        assert torch.equal(a, b), name
    assert any(not torch.equal(a, b) for a, b in zip(plain, other))
    assert plain[list(params).index("layers.0.ffn.w_noise")].abs().max() > 0


def test_three_moe_updates_follow_jax():
    """Three f32 updates with accumulation 2 of the MoE model (capacity on,
    no noise and no expert dropout, so that JAX's step key draws nothing
    that matters) follow ``make_train_step`` + ``optax.MultiSteps``: each
    micro-step's loss within 1e-5, and every parameter's change within 1e-2
    of its largest value (tests/test_torch_training.py's rule: Adam divides
    each gradient by its own magnitude)."""
    jcfg, cfg, tree = _trees(14, noisy_routing_alpha=0.0, use_expert_dropout=False)
    batches = [_batch(15 + i, 2, 32) for i in range(6)]
    tx, _ = jax_step.make_optimizer(1e-3, 3, gradient_accumulation_steps=2)
    state = jax_step.create_train_state(jax.tree.map(jnp.asarray, tree), tx,
                                        jax.random.PRNGKey(0))
    jstep = jax.jit(jax_step.make_train_step(jcfg, tx))
    jlosses = []
    for batch in batches:
        state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jlosses.append(float(metrics["loss"]))
    model = from_jax_params(tree, cfg, device="cpu")
    opt, _ = port_step.make_optimizer(dict(model.named_parameters()),
                                      port_step.decay_mask(model), 1e-3, 3,
                                      gradient_accumulation_steps=2)
    losses = []
    for i, batch in enumerate(batches):
        metrics = port_step.train_step(model, opt, {k: torch.as_tensor(v, dtype=torch.long)
                                                    for k, v in batch.items()}, i)
        assert float(metrics["lb_loss"]) > 0 and float(metrics["rz_loss"]) > 0
        losses.append(float(metrics["loss"]))
    assert opt.count == 3
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        start = _jax_leaf(tree, name)
        _close(p.detach().numpy() - start, _jax_leaf(state.params, name) - start, 1e-2, name)


def test_train_from_config_trains_a_moe_model(tmp_path):
    """``train_from_config`` on a MoE config (``use_expert_system``, 4
    experts, top-2, with the default capacity, noise and expert dropout)
    builds a MoE model and trains it on the CPU: 3 epochs of 3 updates, the
    epoch loss finite and falling, and the final checkpoint written."""
    import json

    from apertis_llm_torch.training import train_from_config
    from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

    vocab_path = tmp_path / "vocab.json"
    create_minimal_vocab_file(vocab_path, 64)
    words = sorted(json.loads(vocab_path.read_text()))
    rng = np.random.default_rng(16)
    data = tmp_path / "train.jsonl"
    data.write_text("".join(json.dumps({"text": " ".join(words[j] for j in
                                                         rng.integers(4, 64, 20))}) + "\n"
                            for _ in range(12)))
    cfg = {"data_config": {"train_data_path": str(data), "tokenizer_path": str(vocab_path),
                           "max_length": 16},
           "model_config": {"target_param_count": "1M", "attention_type": "selective_ssm",
                            "use_expert_system": True, "num_experts": 4, "experts_per_token": 2,
                            "config_overrides": {"hidden_size": 64, "num_hidden_layers": 2,
                                                 "num_attention_heads": 4,
                                                 "intermediate_size": 128,
                                                 "hidden_dropout_prob": 0.0}},
           "training_config": {"output_dir": str(tmp_path / "run"), "batch_size": 4,
                               "learning_rate": 3e-3, "num_epochs": 3,
                               "gradient_accumulation_steps": 1, "device": "cpu",
                               "bf16": False}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    history = train_from_config(str(path))
    losses = history["train_loss"]
    assert history["final_step"] == 9 and np.isfinite(losses).all() and losses[-1] < losses[0]
    saved = json.loads((tmp_path / "run" / "final" / "config.json").read_text())
    assert saved["use_expert_system"] and saved["num_experts"] == 4
