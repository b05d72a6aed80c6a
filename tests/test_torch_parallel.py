"""The port's data- and sequence-parallel training vs the JAX package (CPU,
gloo ranks, tiny models).

Ranks are started with ``apertis_llm_torch.parallel.spawn`` (``torch.
multiprocessing`` with ``spawn``, a gloo process group over a ``FileStore``
under ``tmp_path``, one thread a rank). Each child imports this module to
find its worker, so the module imports JAX only inside its tests: the
parent computes the JAX side and hands the ranks numpy arrays. Two spawns
serve every multi-rank test (module-scoped fixtures): four ranks for the
sequence-parallel scan on mesh (1, 1, 1, 4) and the SSM model's loss,
gradients and updates on (2, 1, 1, 2); two ranks for the MHA model on
(2, 1, 1, 1) and ``train_from_config`` on [1, 1, 1, 2] and [2, 1, 1, 1].
Everything is f32 without dropout; on the CPU the kernels' plain versions
run. Tolerances are the JAX package's own for the same comparisons
(``tests/test_pallas_kernels.py``, ``tests/test_sequence_parallel.py``).
"""

import json

import numpy as np
import pytest
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import check_trainable, init_params
from apertis_llm_torch.ops.ssm import selective_scan
from apertis_llm_torch.parallel import create_mesh, parallel_context, spawn
from apertis_llm_torch.parallel.collectives import all_reduce_sum
from apertis_llm_torch.parallel.sequence import ssm_scan_sequence_parallel
from apertis_llm_torch.training import train_from_config
from apertis_llm_torch.training import pipeline as port_pipeline
from apertis_llm_torch.training.step import (
    decay_mask, loss_fn, make_optimizer, reduce_gradients, shard_batch, train_step)
from apertis_llm_torch.training.trainer import ApertisTrainer

torch.set_num_threads(2)

SCAN_TOL, SCAN_GRAD_TOL = 1e-5, 1e-4       # tests/test_pallas_kernels.py:69-78
LOSS_TOL, GRAD_TOL = 1e-4, 2e-4            # tests/test_sequence_parallel.py:129-160
TRAIN_LOSS_TOL = 1e-4                      # tests/test_sequence_parallel.py:220
SPAWN_TIMEOUT = 240.0

SSM = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, attention_type="selective_ssm", ssm_d_state=8)
MHA = dict(SSM, attention_type="standard_mha", hidden_size=128)   # 4 heads of 32


def _tree(cfg_kw, seed):
    """A JAX init tree of ``cfg_kw``, perturbed off its 0/1 values, as numpy
    f32."""
    import jax

    from apertis_llm_tpu.config import ApertisConfig as JaxConfig
    from apertis_llm_tpu.models.params import init_params as jax_init_params

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + rng.normal(0.0, 0.02, x.shape).astype(np.float32),
                        jax_init_params(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw)))


def _batch(seed, b, l, padded=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, SSM["vocab_size"], (b, l)).astype(np.int64)
    mask = np.ones((b, l), np.int64)
    if padded:
        mask[1, 10:] = 0
        mask[3, 5:] = 0
    labels = np.where(mask > 0, ids, -100)
    labels[0, 3] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _to_torch(part):
    return {k: v if isinstance(v, int) else torch.as_tensor(v) for k, v in part.items()}


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


def _mesh_loss_and_grads(tree, cfg_kw, batch, shape):
    """This rank's model on mesh ``shape``: the global loss and gradients
    (summed over the ranks), and the model."""
    mesh = create_mesh(shape)
    model = from_jax_params(tree, ApertisConfig(**cfg_kw), device="cpu")
    part = _to_torch(shard_batch(batch, mesh))
    params = dict(model.named_parameters())
    with parallel_context(mesh):
        loss, _ = loss_fn(model, part, None)
        grads = torch.autograd.grad(loss, list(params.values()))
    grads = {n: g.contiguous() for n, g in zip(params, grads)}
    reduce_gradients(grads)
    total = loss.detach().clone()
    all_reduce_sum([total])
    return float(total), grads, model, mesh, part


# ---- workers: run in the spawned ranks ---------------------------------------

def _four_rank_worker(rank, a, b, w_last, tree, batch):
    out = {}
    mesh = create_mesh((1, 1, 1, 4))
    chunk = a.shape[2] // 4
    cols = slice(rank * chunk, (rank + 1) * chunk)
    at = torch.tensor(a[:, :, cols]).requires_grad_()
    bt = torch.tensor(b[:, :, cols]).requires_grad_()
    h, h_last = ssm_scan_sequence_parallel(at, bt, mesh)
    loss = (h ** 2).sum() + (h_last * torch.tensor(w_last)).sum()
    da, db = torch.autograd.grad(loss, (at, bt))
    out["scan"] = (h.detach(), h_last.detach(), da, db)

    loss, grads, model, mesh, part = _mesh_loss_and_grads(tree, SSM, batch, (2, 1, 1, 2))
    out["loss"], out["grads"] = loss, grads
    # Two updates with remat: the rematerialised layers take the same route.
    model.config = model.config.replace(remat=True)
    optimizer, _ = make_optimizer(dict(model.named_parameters()), decay_mask(model), 1e-3, 10)
    for step in range(2):
        train_step(model, optimizer, part, step, None, mesh)
    out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


def _two_rank_worker(rank, mha_tree, mha_batch, config_paths, init_tree):
    out = {"mha_loss": _mesh_loss_and_grads(mha_tree, MHA, mha_batch, (2, 1, 1, 1))[0]}
    # train_from_config from the JAX run's initial parameters.
    port_pipeline.init_params = lambda *args, **kwargs: init_tree
    out["histories"] = [train_from_config(path) for path in config_paths]
    return out


# ---- fixtures: one spawn each ------------------------------------------------

@pytest.fixture(scope="module")
def scan_inputs():
    rng = np.random.default_rng(0)
    b, h, l, n = 2, 3, 64, 8        # L over 4 ranks: 16 a chunk
    return (rng.uniform(0.4, 0.999, (b, h, l, n)).astype(np.float32),
            rng.normal(size=(b, h, l, n)).astype(np.float32),
            rng.normal(size=(b, h, n)).astype(np.float32))


@pytest.fixture(scope="module")
def ssm_case():
    return _tree(SSM, 1), _batch(3, 4, 16)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, scan_inputs, ssm_case):
    a, b, w_last = scan_inputs
    tree, batch = ssm_case
    return spawn(_four_rank_worker, 4, tmp_path_factory.mktemp("four_ranks"),
                 (a, b, w_last, tree, batch), timeout=SPAWN_TIMEOUT)


def _corpus(tmp_path):
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast"]
    vocab.update({w: 4 + i for i, w in enumerate(words)})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    rng = np.random.default_rng(0)
    (tmp_path / "train.jsonl").write_text("\n".join(
        json.dumps({"text": " ".join(rng.choice(words, 10))}) for _ in range(16)))


def _pipeline_config(tmp_path, mesh_shape, out, device=None):
    train = {"task_type": "pretrain", "output_dir": str(tmp_path / out), "batch_size": 8,
             "learning_rate": 1e-3, "num_epochs": 1, "gradient_accumulation_steps": 1,
             "bf16": False, "use_gradient_checkpointing": True, "mesh_shape": mesh_shape}
    if device:
        train["device"] = device
    path = tmp_path / f"{out}.json"
    path.write_text(json.dumps({
        "data_config": {"train_data_path": str(tmp_path / "train.jsonl"),
                        "tokenizer_path": str(tmp_path / "vocab.json"), "max_length": 16},
        "model_config": {"target_param_count": "10M", "attention_type": "selective_ssm",
                         "ssm_d_state": 8,
                         "config_overrides": {
                             "hidden_size": 64, "num_hidden_layers": 2,
                             "num_attention_heads": 4, "intermediate_size": 128,
                             "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}},
        "training_config": train}))
    return str(path)


@pytest.fixture(scope="module")
def jax_train_run(tmp_path_factory):
    """JAX ``train_from_config`` on mesh [4, 1, 1, 2] of its 8 CPU devices:
    its history and its initial parameters (numpy)."""
    import jax

    from apertis_llm_tpu.training import pipeline as jax_pipeline
    from apertis_llm_tpu.training import train_from_config as jax_train_from_config

    tmp_path = tmp_path_factory.mktemp("train")
    _corpus(tmp_path)
    trees = []
    real_init = jax_pipeline.init_params

    def recording_init(*args, **kwargs):
        tree = real_init(*args, **kwargs)     # the trainer donates it: keep a copy
        trees.append(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))
        return tree

    jax_pipeline.init_params = recording_init
    try:
        history = jax_train_from_config(_pipeline_config(tmp_path, [4, 1, 1, 2], "jax"))
    finally:
        jax_pipeline.init_params = real_init
    return tmp_path, history, trees[0]


@pytest.fixture(scope="module")
def mha_case():
    return _tree(MHA, 5), _batch(6, 4, 16, padded=True)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_train_run, mha_case):
    tmp_path, _, init_tree = jax_train_run
    paths = [_pipeline_config(tmp_path, shape, f"port_{i}", device="cpu")
             for i, shape in enumerate(([1, 1, 1, 2], [2, 1, 1, 1]))]
    return spawn(_two_rank_worker, 2, tmp_path_factory.mktemp("two_ranks"),
                 (*mha_case, paths, init_tree), timeout=SPAWN_TIMEOUT)


# ---- (a) the carried-state scan against JAX ------------------------------------

@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "h_init"])
@pytest.mark.parametrize("jax_fn", ["xla", "pallas"])
def test_selective_scan_matches_jax(scan_inputs, jax_fn, with_init):
    """``ops/ssm.py::selective_scan`` (its plain version here) against JAX
    ``ops/ssm.py::selective_scan`` (the associative scan) or
    ``selective_scan_pallas`` (#2, interpret mode), from zero or from an
    ``h_init``: h and h_last within 1e-5, and the gradients of a, b and
    h_init (``jax.grad``, through the custom VJP for #2) within 1e-4."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from apertis_llm_tpu.ops import ssm as jax_ssm
    from apertis_llm_tpu.ops.pallas.ssm_scan import selective_scan_pallas

    a, b, w = scan_inputs
    h0 = np.random.default_rng(7).normal(size=w.shape).astype(np.float32) if with_init else None
    jax_scan = jax_ssm.selective_scan if jax_fn == "xla" else selective_scan_pallas

    def jax_loss(a, b, h0):
        h, h_last = jax_scan(a, b, h0)
        return jnp.sum(jnp.sin(h)) + jnp.sum(h_last * w), (h, h_last)

    args = [jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0)]
    argnums = (0, 1, 2) if with_init else (0, 1)
    with pltpu.force_tpu_interpret_mode():
        (_, (jh, jlast)), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums, has_aux=True))(
            *args)

    ta, tb = torch.tensor(a).requires_grad_(), torch.tensor(b).requires_grad_()
    th0 = None if h0 is None else torch.tensor(h0).requires_grad_()
    h, h_last = selective_scan(ta, tb, th0)
    loss = torch.sin(h).sum() + (h_last * torch.tensor(w)).sum()
    grads = torch.autograd.grad(loss, [t for t in (ta, tb, th0) if t is not None])
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(h_last.detach().numpy(), np.asarray(jlast), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    for name, got, ref in zip(("da", "db", "dh_init"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCAN_GRAD_TOL,
                                   atol=SCAN_GRAD_TOL, err_msg=name)


def test_selective_scan_dtypes():
    """The dtypes follow ``ssm_scan.py:129-194``: an f32 carry, ``h`` and
    ``h_last`` in ``b_term``'s dtype (``h_last`` the last step of the cast
    ``h``), ``da`` in ``a_bar``'s dtype, ``dh_init`` in ``h_init``'s."""
    from apertis_llm_torch.ops.ssm import CarriedScan

    rng = np.random.default_rng(8)
    a = torch.tensor(rng.uniform(0.4, 0.999, (1, 2, 9, 4)), dtype=torch.float64)
    b = torch.tensor(rng.normal(size=(1, 2, 9, 4)), dtype=torch.bfloat16)
    h0 = torch.tensor(rng.normal(size=(1, 2, 4)), dtype=torch.float64)
    ref_h = torch.empty((1, 2, 9, 4))
    carry = h0.float()
    for t in range(9):
        carry = a[:, :, t].float() * carry + b[:, :, t].float()
        ref_h[:, :, t] = carry
    h, h_last = selective_scan(a, b, h0)
    assert h.dtype == h_last.dtype == torch.bfloat16
    assert torch.equal(h, ref_h.to(torch.bfloat16)) and torch.equal(h_last, h[:, :, -1])

    class Ctx:    # CarriedScan's own backward, without autograd's casts
        saved_tensors = (a.float(), ref_h, h0.float())
        dtypes = (a.dtype, h0.dtype)

    da, db, dh0 = CarriedScan.backward(Ctx, torch.ones_like(h), torch.zeros_like(h_last))
    assert (da.dtype, db.dtype, dh0.dtype) == (torch.float64, torch.float32, torch.float64)


# ---- (b) the sequence-parallel scan on four ranks -------------------------------

def test_sequence_parallel_scan_matches_jax(four_ranks, scan_inputs):
    """``ssm_scan_sequence_parallel`` with L over four ranks (mesh (1, 1, 1,
    4)) against JAX's single-device ``selective_scan``: each rank's chunk of
    h and the replicated h_last within 1e-5, and the gradients of
    ``sum(h^2) + sum(h_last * w)`` (h_last counted once a rank) within
    1e-4."""
    import jax
    import jax.numpy as jnp

    from apertis_llm_tpu.ops.ssm import selective_scan as jax_scan

    a, b, w = scan_inputs

    def jax_loss(a, b):
        h, h_last = jax_scan(a, b)
        return jnp.sum(h ** 2) + 4 * jnp.sum(h_last * w), (h, h_last)

    (_, (jh, jlast)), (jda, jdb) = jax.jit(jax.value_and_grad(jax_loss, (0, 1), has_aux=True))(
        jnp.asarray(a), jnp.asarray(b))
    parts = [r["scan"] for r in four_ranks]
    np.testing.assert_allclose(torch.cat([p[0] for p in parts], 2).numpy(), np.asarray(jh),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    for p in parts:
        np.testing.assert_allclose(p[1].numpy(), np.asarray(jlast), rtol=SCAN_TOL, atol=SCAN_TOL)
    for i, ref in ((2, jda), (3, jdb)):
        np.testing.assert_allclose(torch.cat([p[i] for p in parts], 2).numpy(), np.asarray(ref),
                                   rtol=SCAN_GRAD_TOL, atol=SCAN_GRAD_TOL)


# ---- (c), (d), (f) the SSM model on mesh (2, 1, 1, 2) ---------------------------

def _jax_sp_loss(tree, cfg_kw, batch, shape):
    """JAX ``loss_fn`` under its own parallel context on ``shape``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from apertis_llm_tpu.config import ApertisConfig as JaxConfig
    from apertis_llm_tpu.parallel.context import parallel_context as jax_parallel_context
    from apertis_llm_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from apertis_llm_tpu.training.step import loss_fn as jax_loss_fn

    config = JaxConfig(**cfg_kw)
    mesh = jax_create_mesh(jax.devices()[:int(np.prod(shape))], shape)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree), NamedSharding(mesh, P()))
    jbatch = jax.device_put({k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
                            NamedSharding(mesh, P("data")))

    def sp_loss(p, bt):
        with jax_parallel_context(mesh, sp_axis="seq", batch_axis="data"):
            return jax_loss_fn(p, config, bt, None)[0]

    return float(jax.jit(sp_loss)(params, jbatch))


def _jax_loss_and_grads(tree, cfg_kw, batch):
    import jax
    import jax.numpy as jnp

    from apertis_llm_tpu.config import ApertisConfig as JaxConfig
    from apertis_llm_tpu.training.step import loss_fn as jax_loss_fn

    config = JaxConfig(**cfg_kw)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jax_loss_fn(p, config, bt, None, None), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    return float(loss), grads


def test_ssm_loss_on_data_and_seq_mesh_matches_jax(four_ranks, ssm_case):
    """The SSM model's loss on mesh (2, 1, 1, 2) (each rank 2 rows x 8
    positions, summed over the ranks) against JAX ``loss_fn`` on one device
    and under JAX's own parallel context on (2, 1, 1, 2), within 1e-4; every
    rank holds the same global loss."""
    tree, batch = ssm_case
    single, _ = _jax_loss_and_grads(tree, SSM, batch)
    jax_sp = _jax_sp_loss(tree, SSM, batch, (2, 1, 1, 2))
    losses = [r["loss"] for r in four_ranks]
    assert len(set(losses)) == 1
    assert abs(losses[0] - single) < LOSS_TOL, (losses[0], single)
    assert abs(losses[0] - jax_sp) < LOSS_TOL, (losses[0], jax_sp)


def test_ssm_gradients_on_data_and_seq_mesh_match_jax(four_ranks, ssm_case):
    """Every parameter's gradient on mesh (2, 1, 1, 2), summed over the
    ranks, against ``jax.grad`` of the single-device loss within 2e-4."""
    tree, batch = ssm_case
    _, jgrads = _jax_loss_and_grads(tree, SSM, batch)
    grads = four_ranks[0]["grads"]
    assert len(grads) == len(four_ranks[3]["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _jax_leaf(jgrads, name), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_parameters_bit_equal_across_ranks_after_two_updates(four_ranks, ssm_case):
    """After two remat updates on mesh (2, 1, 1, 2) every rank holds the same
    parameters, bit for bit, and they moved."""
    tree, _ = ssm_case
    ref = four_ranks[0]["params"]
    for other in four_ranks[1:]:
        for name, p in ref.items():
            assert torch.equal(p, other["params"][name]), name
    moved = [n for n, p in ref.items() if not np.array_equal(p.numpy(), _jax_leaf(tree, n))]
    assert len(moved) == len(ref)


# ---- (c) the MHA model on (2, 1, 1, 1) and (e) train_from_config -----------------

def test_mha_loss_on_data_mesh_matches_jax(two_ranks, mha_case):
    """The MHA model (padded rows, plain attention under the padding bias)
    on mesh (2, 1, 1, 1) against JAX ``loss_fn`` on one device, within
    1e-4."""
    single, _ = _jax_loss_and_grads(*mha_case[:1], MHA, mha_case[1])
    losses = [r["mha_loss"] for r in two_ranks]
    assert losses[0] == losses[1]
    assert abs(losses[0] - single) < LOSS_TOL, (losses[0], single)


def test_train_from_config_on_meshes_matches_jax(two_ranks, jax_train_run):
    """``train_from_config`` with ``mesh_shape`` [1, 1, 1, 2] and
    [2, 1, 1, 1] on two ranks, from the JAX run's initial parameters: the
    first train loss agrees between the meshes and with JAX's run of the same
    config on [4, 1, 1, 2] within 1e-4, and every rank returns the same
    history."""
    _, jax_history, _ = jax_train_run
    sp, dp = two_ranks[0]["histories"]
    assert two_ranks[1]["histories"][0]["train_loss"] == sp["train_loss"]
    assert two_ranks[1]["histories"][1]["train_loss"] == dp["train_loss"]
    assert np.isfinite(sp["train_loss"][0])
    assert abs(sp["train_loss"][0] - dp["train_loss"][0]) < TRAIN_LOSS_TOL
    assert abs(sp["train_loss"][0] - jax_history["train_loss"][0]) < TRAIN_LOSS_TOL


# ---- (g) the meshes the port trains on, and the refusals -------------------------

def test_supported_meshes_pass_the_gate():
    """``check_trainable`` takes (data, 1, 1, seq) for the dense SSM model
    and (data, 1, 1, 1) for the MHA model."""
    ssm, mha = ApertisConfig(**SSM), ApertisConfig(**MHA)
    for shape in ((2, 1, 1, 2), (1, 1, 1, 4), (4, 1, 1, 1), (2, 1, 1), None):
        check_trainable(ssm, device="cpu", mesh_shape=shape)
    check_trainable(mha, device="cpu", mesh_shape=(4, 1, 1, 1))


def _tiny_dataset(n=4, length=8):
    ids = np.arange(n * length).reshape(n, length).astype(np.int32) % 90 + 4
    return [{"input_ids": row, "labels": row} for row in ids]


@pytest.mark.parametrize("case", ["model axis", "expert axis", "moe on data", "mha on seq",
                                  "mesh not the world"])
def test_unported_meshes_are_refused(case):
    """A ``model`` or ``expert`` axis, a MoE model on any mesh and MHA under
    ``seq`` raise ``NotImplementedError`` naming ROADMAP.md; a mesh whose
    product is not the number of ranks raises ``ValueError``."""
    cfg_kw, shape, error = {
        "model axis": (SSM, (1, 2, 1, 1), NotImplementedError),
        "expert axis": (SSM, (1, 1, 2, 1), NotImplementedError),
        "moe on data": (dict(SSM, use_expert_system=True, num_experts=4, experts_per_token=2),
                        (2, 1, 1, 1), NotImplementedError),
        "mha on seq": (MHA, (1, 1, 1, 2), NotImplementedError),
        "mesh not the world": (SSM, (2, 1, 1, 1), ValueError),
    }[case]
    cfg = ApertisConfig(**cfg_kw)
    tree = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "cover"):
        ApertisTrainer(cfg, tree, _tiny_dataset(), batch_size=2, mesh_shape=shape, device="cpu")
