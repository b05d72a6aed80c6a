#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. identify the card and the toolchain (nvidia-smi, torch, CUDA, nvcc,
     Triton);
  2. build the port's CUDA kernels from ``apertis_llm_torch/csrc`` with nvcc;
  3. build the 1.5B text-only selective-SSM model in bf16 on the card from a
     seeded generator, with seeded noise on every norm weight and bias, FFN
     bias and skip weight D (their init values 1 and 0 would hide a kernel
     that dropped them); show that the kernel checks can see each of those
     terms (the plain version without it differs by more than the
     tolerance); then hold each kernel against its plain PyTorch version on
     the card, at the shapes the requests below give it, at a ragged size
     and in every variant its wrapper accepts (RMSNorm, ffn_mode "none", f32
     scan operands, ReLU and SiLU), and time both with CUDA events;
  4. serve two batches through ``InferenceEngine.generate`` (4 ragged prompts
     of 7/19/32/45 tokens, greedy, 24 new tokens, one EOS id; 64 prompts of 32
     tokens, greedy, 64 new tokens), with every kernel's launch counter set
     to 0 just before and checked just after (layers x calls), tokens in
     range and each request repeated with the same tokens; then TTFT and
     decode tokens per second per batch;
  5. check a 2-layer model on the card against the same weights on the CPU
     (plain versions), and that the 1.5B logits are finite.
Before the last line it prints the kernels' JSON summary and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.

It needs a CUDA device and exits non-zero without one. It imports no JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_ULP = 2.0 ** -7      # one bf16 ulp relative to the largest value
F32_TOL = 1e-3            # f32 outputs computed from bf16-rounded operands
SCAN_F32_TOL = 1e-4       # f32 carry; op fusion differs per step
NOISE_STD = 0.1           # seeded noise on norms, biases and D


def log(*args):
    print(*args, flush=True)


def run_text(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def card_line():
    return run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0].strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, rel_tol):
    """Max abs error of got vs ref (in f32); raise past rel_tol * max|ref|."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    bound = rel_tol * float(ref.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= bound
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound:.3e} = {rel_tol:.2e} x max|ref|)"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def perturb_(model, generator):
    """Add seeded noise to every norm weight and bias, FFN bias and skip
    weight D, which init_params sets to 1 or 0, so that every term the
    kernels compute has a value that shows when it is dropped."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            is_norm = "norm" in name
            if is_norm or leaf == "D" or (".ffn.w" in name and leaf == "b"):
                noise = torch.randn(p.shape, generator=generator, device=p.device)
                scale = 5 * NOISE_STD if leaf == "D" else NOISE_STD
                p.add_((noise * scale).to(p.dtype))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.config import ApertisConfig
    from apertis_llm_torch.inference.engine import InferenceEngine
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import count_params, init_params
    from apertis_llm_torch.ops.kernels import _build
    from apertis_llm_torch.ops.kernels.ffn_fused import ffn_decode, ffn_decode_reference
    from apertis_llm_torch.ops.kernels.ssm_scan import (
        selective_scan_fwd, selective_scan_fwd_reference)
    from apertis_llm_torch.ops.kernels.ssm_step import (
        ssm_decode_step, ssm_decode_step_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # ---- 1. identify ------------------------------------------------------
    log(f"card: {card}")
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {run_text([_build._nvcc(), '--version']).splitlines()[-1]}, "
        f"triton {triton_version}, python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. the 1.5B model and the kernel checks ----------------------------
    dims = calculate_model_dimensions("1.5B", 32000)
    config = ApertisConfig(
        vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
        hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=4096,
        dtype="bfloat16", param_dtype="bfloat16")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_params(config, gen, device=dev, dtype=torch.bfloat16)
    n_params = count_params(tree)
    model = from_jax_params(tree, config, device=dev, dtype=torch.bfloat16)
    del tree
    perturb_(model, torch.Generator(device=dev).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    log(f"model: {n_params:,} parameters, hidden {config.hidden_size}, "
        f"{config.num_hidden_layers} layers, {config.num_attention_heads} heads, "
        f"d_inner {config.ssm_d_inner}, dt_rank {config.ssm_dt_rank}, FFN "
        f"{config.intermediate_size}, bf16, built in {time.perf_counter() - t0:.1f} s")

    layer = model.layers[0]
    mixer = layer.attn.mixer_weights()
    ffn_norm = layer.ffn.pre_norm.weights()
    heads, n, c, d = (config.num_attention_heads, config.ssm_d_state,
                      config.ssm_d_inner, config.hidden_size)
    eps = config.layer_norm_eps
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    errs, times = {}, {}   # kernel -> worst error; kernel -> (ms, plain_ms) at 64 rows

    def check_kernel(key, label, args, kernel, plain, tols, timed=False):
        """Run the kernel and its plain version on ``args``, compare each
        output with its tolerance, and time both."""
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if len(got) != len(ref):
            raise RuntimeError(f"{label}: {len(got)} outputs, plain version {len(ref)}")
        for (out_name, tol), a, b in zip(tols, got, ref):
            errs[key] = max(errs.get(key, 0.0), compare(f"{label} {out_name}", a, b, tol))
        k_ms = cuda_ms(lambda: kernel(*args))
        p_ms = cuda_ms(lambda: plain(*args))
        log(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if timed:
            times[key] = (k_ms, p_ms)

    def check_sensitive(label, plain, args, variants, tols):
        """Each variant drops one term from ``args``; the plain version's
        outputs must then move by more than a kernel check's tolerance, so a
        kernel that dropped the term would fail that check."""
        base = plain(*args)
        base = base if isinstance(base, tuple) else (base,)
        for term, changed in variants.items():
            out = plain(*changed)
            out = out if isinstance(out, tuple) else (out,)
            moved = [(float((o.float() - b.float()).abs().max()),
                      tol * float(b.float().abs().max()), name)
                     for (name, tol), o, b in zip(tols, out, base)]
            shift, bound, name = max(moved, key=lambda m: m[0] / m[1])
            ok = shift > bound
            log(f"  sensitivity {label}, {term}: {name} moves {shift:.3e} "
                f"(tolerance {bound:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label}: the check cannot see {term}")

    log("kernel checks (bf16 in, f32 carry/accumulation), CUDA-event times:")

    def scan_inputs(b, l, bc_dtype=torch.bfloat16, out_dtype=torch.bfloat16):
        lens = {4: [7, 19, 32, 45], 64: [32] * 64}.get(
            b, torch.randint(1, l + 1, (b,), generator=g, device=dev).tolist())
        mask = (torch.arange(l, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        delta = torch.nn.functional.softplus(randn(b, l, heads, dtype=torch.float32) - 4.0)
        a_cont = -torch.exp(layer.attn.A_log.float())
        return (delta, a_cont, randn(b, l, heads, n, dtype=bc_dtype),
                randn(b, l, heads, n, dtype=bc_dtype), mask, out_dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    for (b, l), bc_dtype, out_dtype in [((4, 64), bf16, bf16), ((64, 32), bf16, bf16),
                                        ((5, 37), bf16, bf16), ((5, 37), bf16, f32),
                                        ((5, 37), f32, bf16), ((5, 37), f32, f32)]:
        y_tol = BF16_ULP if out_dtype == bf16 else SCAN_F32_TOL
        check_kernel("selective_scan_fwd",
                     f"scan B={b} L={l} b/c {str(bc_dtype)[6:]} y {str(out_dtype)[6:]}",
                     scan_inputs(b, l, bc_dtype, out_dtype), selective_scan_fwd,
                     selective_scan_fwd_reference, [("y", y_tol), ("h_last", SCAN_F32_TOL)],
                     timed=(b, l) == (64, 32))

    step_tols = [("h_out", BF16_ULP), ("x_proj", BF16_ULP), ("ssm", F32_TOL),
                 ("ffn_in", BF16_ULP)]
    mixer_rms = mixer._replace(norm_b=None)
    ffn_norm_rms = (ffn_norm[0], None)

    def step_inputs(b, w=mixer, fn=ffn_norm):
        return (randn(b, d), randn(b, config.ssm_conv_kernel - 1, c),
                randn(b, c, dtype=torch.float32), w, eps, fn)

    args = step_inputs(5)

    def without(**terms):
        return args[:3] + (mixer._replace(**terms),) + args[4:]

    check_sensitive("decode step", ssm_decode_step_reference, args, {
        "pre-norm weight": without(norm_w=torch.ones_like(mixer.norm_w)),
        "pre-norm bias": without(norm_b=torch.zeros_like(mixer.norm_b)),
        "conv bias": without(conv_b=torch.zeros_like(mixer.conv_b)),
        "dt bias": without(dt_b=torch.zeros_like(mixer.dt_b)),
        "D * x skip": without(d_skip=torch.zeros_like(mixer.d_skip)),
        "FFN pre-norm weight": args[:5] + ((torch.ones_like(ffn_norm[0]), ffn_norm[1]),),
        "FFN pre-norm bias": args[:5] + ((ffn_norm[0], torch.zeros_like(ffn_norm[1])),),
    }, step_tols)
    for b, w, fn, label in [(4, mixer, ffn_norm, "LayerNorm, dense"),
                            (64, mixer, ffn_norm, "LayerNorm, dense"),
                            (5, mixer, ffn_norm, "LayerNorm, dense"),
                            (5, mixer, None, "LayerNorm, ffn_mode none"),
                            (5, mixer_rms, ffn_norm_rms, "RMSNorm, dense"),
                            (5, mixer_rms, None, "RMSNorm, ffn_mode none")]:
        check_kernel("ssm_decode_step", f"decode step B={b} {label}", step_inputs(b, w, fn),
                     ssm_decode_step, ssm_decode_step_reference, step_tols, timed=b == 64)

    w1, w2 = layer.ffn.w1, layer.ffn.w2

    def ffn_inputs(s, act=config.hidden_act):
        return (randn(s, d), w1.w, w1.b, w2.w, w2.b, act)

    args = ffn_inputs(5)
    check_sensitive("ffn", ffn_decode_reference, args, {
        "b1": args[:2] + (torch.zeros_like(w1.b),) + args[3:],
        "b2": args[:4] + (torch.zeros_like(w2.b),) + args[5:],
    }, [("out", BF16_ULP)])
    for s_, act in [(4, config.hidden_act), (64, config.hidden_act), (5, config.hidden_act),
                    (5, "relu"), (5, "silu")]:
        check_kernel("ffn_decode", f"ffn S={s_} {act}", ffn_inputs(s_, act), ffn_decode,
                     ffn_decode_reference, [("out", BF16_ULP)], timed=s_ == 64)

    # ---- 4. serve -----------------------------------------------------------
    engine = InferenceEngine(config, model)
    rng = np.random.default_rng(SEED)
    lens_a = [7, 19, 32, 45]
    batch_a = np.zeros((4, max(lens_a)), np.int32)
    mask_a = np.zeros_like(batch_a)
    for row, length in enumerate(lens_a):
        batch_a[row, :length] = rng.integers(4, config.vocab_size, length)
        mask_a[row, :length] = 1
    batch_b = rng.integers(4, config.vocab_size, (64, 32)).astype(np.int32)
    requests = {
        "A (4 ragged prompts 7/19/32/45, 24 new)": (
            batch_a, mask_a, dict(max_new_tokens=24, eos_token_id=config.eos_token_id)),
        "B (64 prompts x 32, 64 new)": (
            batch_b, None, dict(max_new_tokens=64, eos_token_id=())),
    }
    counters = (selective_scan_fwd, ssm_decode_step, ffn_decode)
    for f in counters:
        f.launches = 0
    first = {}
    for name, (ids, mask, kw) in requests.items():
        first[name] = engine.generate(ids, attention_mask=mask, **kw)
    launches = {f.__name__: f.launches for f in counters}

    nl = config.num_hidden_layers
    decode_calls = 0
    for name, (ids, _, kw) in requests.items():
        out = first[name]
        n_new = out.shape[1] - ids.shape[1]
        if out.shape[0] != ids.shape[0] or not 1 <= n_new <= kw["max_new_tokens"]:
            raise RuntimeError(f"request {name}: output shape {out.shape}")
        if not np.array_equal(out[:, :ids.shape[1]], ids):
            raise RuntimeError(f"request {name}: prompt columns changed")
        new = out[:, ids.shape[1]:]
        if new.min() < 0 or new.max() >= config.vocab_size:
            raise RuntimeError(f"request {name}: token outside [0, {config.vocab_size})")
        decode_calls += n_new - 1
        log(f"request {name}: {n_new} new tokens, first row {new[0, :8].tolist()}...")
    expected = {"selective_scan_fwd": nl * len(requests),
                "ssm_decode_step": nl * decode_calls, "ffn_decode": nl * decode_calls}
    log(f"launch counts in the two requests: {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("a kernel of the main path was not launched as expected")

    serve = {}
    for name, (ids, mask, kw) in requests.items():
        t0 = time.perf_counter()
        again = engine.generate(ids, attention_mask=mask, **kw)
        total = time.perf_counter() - t0
        if not np.array_equal(again, first[name]):
            raise RuntimeError(f"request {name}: a repeated request gave other tokens")
        t0 = time.perf_counter()
        engine.generate(ids, attention_mask=mask, **dict(kw, max_new_tokens=1))
        ttft = time.perf_counter() - t0
        steps = again.shape[1] - ids.shape[1] - 1
        rate = ids.shape[0] * steps / max(total - ttft, 1e-9)
        log(f"serve {name}: TTFT {ttft * 1e3:.1f} ms, decode {rate:.1f} tok/s "
            f"({steps} steps x {ids.shape[0]} rows, {total:.3f} s in all), "
            f"repeat identical; card: {card}")
        serve[name] = dict(ttft_ms=ttft * 1e3, decode_tok_s=rate)

    # ---- 5. outputs are right -----------------------------------------------
    cache = model.init_cache(4)
    pre = model.prefill(cache, torch.as_tensor(batch_a, dtype=torch.long, device=dev),
                        torch.as_tensor(mask_a, device=dev),
                        logit_positions=torch.as_tensor(mask_a.sum(1) - 1, device=dev))
    logits, _ = model.decode_step(cache, pre.logits[:, 0].argmax(-1))
    if pre.logits.shape != (4, 1, config.vocab_size) or logits.shape != (4, config.vocab_size):
        raise RuntimeError("1.5B logits have the wrong shape")
    if not (torch.isfinite(pre.logits).all() and torch.isfinite(logits).all()):
        raise RuntimeError("1.5B logits are not finite")
    log("1.5B prefill and decode logits: finite, shapes (4, 1, 32000) and (4, 32000)")

    small = ApertisConfig(
        vocab_size=1000, attention_type="selective_ssm", ssm_d_state=16, hidden_size=256,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=1024,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype="bfloat16",
        param_dtype="bfloat16")
    tree = init_params(small, torch.Generator().manual_seed(SEED), dtype=torch.bfloat16)
    models = {"gpu": from_jax_params(tree, small, device=dev, dtype=torch.bfloat16),
              "cpu": from_jax_params(tree, small, device="cpu", dtype=torch.bfloat16)}
    perturb_(models["cpu"], torch.Generator().manual_seed(SEED + 3))
    models["gpu"].load_state_dict(models["cpu"].state_dict())
    ids = torch.as_tensor(batch_a % small.vocab_size, dtype=torch.long)
    mask = torch.as_tensor(mask_a)
    caches = {k: m.init_cache(4) for k, m in models.items()}
    logits = {k: m.prefill(caches[k], ids.to(m.device), mask.to(m.device),
                           logit_positions=(mask.sum(1) - 1).to(m.device)).logits[:, 0]
              for k, m in models.items()}
    small_err = 0.0
    for i in range(5):
        # Both sides decode the CPU side's argmax, so their inputs agree.
        small_err = max(small_err, compare(
            f"2-layer model on the card vs the CPU, logits of step {i}",
            logits["gpu"].cpu(), logits["cpu"], 4 * BF16_ULP))
        tok = logits["cpu"].argmax(-1)
        logits = {k: m.decode_step(caches[k], tok.to(m.device))[0]
                  for k, m in models.items()}

    # ---- report -------------------------------------------------------------
    replaces = {
        "selective_scan_fwd": ("apertis_llm_torch/csrc/ssm_scan.cu",
                               "apertis_llm_tpu/ops/pallas/ssm_scan.py:327"),
        "ssm_decode_step": ("apertis_llm_torch/csrc/ssm_step.cu",
                            "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
        "ffn_decode": ("apertis_llm_torch/csrc/ffn_fused.cu",
                       "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        err, (ms, plain_ms) = errs[name], times[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": tpu,
                        "launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels, "serve": serve,
                      "small_model_max_abs_err": small_err}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
