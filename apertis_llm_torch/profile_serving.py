"""Where the time of serving and training goes: ``torch.profiler`` over
prefill and decode, or over train steps.

    python -m apertis_llm_torch.profile_serving [--layers N] [--moe | --mha] [--int4]
        [--quant-matmul {dyn,weightonly,pallas,fused}] [--moe-mode {fatk,kernel,0}] [--train]

Builds the 1.5B selective-SSM model on the card from a seeded generator
(``chip_smoke.py``'s configuration, random weights; with ``--moe`` the 1.5B
top-2-of-8 MoE preset instead, with ``--mha`` the 1.5B MHA preset), in bf16
and with int8 weights (``quantize_params`` on the card, the int8 tied head
and, for MHA, the fused QKV projection attached by the engine), and for each
traces one prefill of 64 prompts x 32 tokens and of 4 x 64 tokens (the
smoke's requests B and A, bucketed as ``InferenceEngine`` buckets them) and
five decode steps at 64 and at 4 rows, after a warm-up; an MHA model decodes
over a cache of the prompt plus 64 slots (bf16 for the bf16 model, int8 for
the int8 one, as the engine allocates them), at its last slot. For each phase it
prints the host wall time per call, the device time per call (the sum of the
CUDA kernels' times, each kernel counted once), the device's idle share
(1 - device / wall) and the kernels that take the most device time, with the
card's name and power limit. With ``--int4`` it also traces w4a8 serving
(``InferenceEngine(..., quant_bits=4)`` on the int8 model: int8 prefill, the
int4 decode FFN or fat stacks); with ``--moe --int4`` the MoE model is the 3B
preset (hidden 768, 74 layers, experts of 3072), whose widths take the int4
fat stack (the 1.5B one stays int8). ``--quant-matmul`` and ``--moe-mode``
serve every model through ``InferenceEngine(..., quant_matmul=...,
moe_mode=...)``: the int8 arithmetic of the full-sequence linears and the
head (``dyn`` by default; ``weightonly``, ``pallas``, ``fused``), and the MoE
FFN's serving stack (``fatk`` by default; ``kernel``; ``0``, none). It needs
a CUDA device.

With ``--train`` it traces training instead: the dense 1.5B preset (or the
MHA one with ``--mha``, through the flash kernels, or the MoE one with
``--moe``, through ``moe_dispatch`` and the scan kernels) with f32 masters, bf16
compute, remat and accumulation over 2, ``chip_smoke.py``'s training phase,
two micro-steps (one update) at batch 4 x 1024 after a warm-up.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from apertis_llm_torch.models.params import MOE_MODES, QUANT_MATMUL_MODES


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.splitlines()[0].strip()


def _device_us(prof) -> dict:
    """Device microseconds by kernel name: the profiler's CUDA kernel events
    only, so a kernel is counted once and not again under its aten op."""
    totals = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            totals[ev.name] = totals.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return totals


def _trace(label, fn, calls, card, top=8):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    by_kernel = _device_us(prof)
    device = sum(by_kernel.values()) / calls / 1e3
    print(f"{label}: wall {wall:.3f} ms, device {device:.3f} ms per call, idle share "
          f"{1 - device / wall:.2f}, {len(by_kernel)} kernels; card: {card}", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / calls:9.1f} us  {name[:110]}", flush=True)


def _profile_train(config, dev, card) -> int:
    """Two warm micro-steps of training (one update with accumulation 2)."""
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.training.step import decay_mask, make_optimizer, train_step

    config = config.replace(remat=True)
    tree = init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    model = from_jax_params(tree, config, device=dev, dtype=torch.float32)
    del tree
    opt, _ = make_optimizer(dict(model.named_parameters()), decay_mask(model), 3e-4, 100,
                            gradient_accumulation_steps=2)
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(4, config.vocab_size, (4, 1024), generator=gen, device=dev)
    batch = {"input_ids": ids, "labels": ids}
    seed = [0]

    def two_micro_steps():
        for _ in range(2):
            train_step(model, opt, batch, seed[0], torch.bfloat16)
            seed[0] += 1

    kind = ("MHA (flash)" if config.attention_type == "standard_mha" else
            "MoE selective SSM" if config.use_expert_system else "selective SSM")
    print(f"card: {card}; {config.num_hidden_layers} layers, training {kind}", flush=True)
    _trace("train, two micro-steps of 4 x 1024 (one update)", two_micro_steps, 2, card, top=12)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the depth (default: the preset's)")
    family = parser.add_mutually_exclusive_group()
    family.add_argument("--moe", action="store_true",
                        help="the 1.5B MoE preset (8 experts, top-2) instead of the dense one")
    family.add_argument("--mha", action="store_true",
                        help="the 1.5B MHA preset instead of the selective-SSM one")
    parser.add_argument("--int4", action="store_true",
                        help="also trace w4a8 serving (quant_bits=4) of the int8 model")
    parser.add_argument("--quant-matmul", default="dyn", choices=QUANT_MATMUL_MODES,
                        help="the int8 linears' arithmetic (InferenceEngine's quant_matmul)")
    parser.add_argument("--moe-mode", default="fatk", choices=MOE_MODES,
                        help="the MoE FFN's kernel (InferenceEngine's moe_mode)")
    parser.add_argument("--train", action="store_true",
                        help="trace train steps instead of serving")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    from apertis_llm_torch.config import ApertisConfig
    from apertis_llm_torch.inference.engine import InferenceEngine
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.models.quantize import quantize_params

    dev = torch.device("cuda", 0)
    card = _card()
    preset = "3B" if args.moe and args.int4 else "1.5B"
    dims = calculate_model_dimensions(preset, 32000, use_expert_system=args.moe)
    moe = dict(use_expert_system=True, num_experts=8, experts_per_token=2) if args.moe else {}
    config = ApertisConfig(
        vocab_size=32000, attention_type="standard_mha" if args.mha else "selective_ssm",
        ssm_d_state=16,
        hidden_size=dims["hidden_size"],
        num_hidden_layers=args.layers or dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=4096,
        dtype="bfloat16", param_dtype="bfloat16", use_flash_attention=args.mha, **moe)
    if args.train:
        return _profile_train(config, dev, _card())
    tree = init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                       dtype=torch.bfloat16)
    models = {"bf16": from_jax_params(tree, config, device=dev, dtype=torch.bfloat16),
              "int8": from_jax_params(quantize_params(tree), config, device=dev,
                                      dtype=torch.bfloat16)}
    del tree
    gen = torch.Generator(device=dev).manual_seed(1)
    kinds = [("bf16", 8), ("int8", 8)] + ([("w4a8", 4)] if args.int4 else [])
    print(f"card: {card}; {preset} preset, {config.num_hidden_layers} layers, quant_matmul "
          f"{args.quant_matmul}, moe_mode {args.moe_mode}", flush=True)
    for kind, bits in kinds:
        model = models["bf16" if kind == "bf16" else "int8"]
        # Attaches the int8 head, MoE fat stacks, MHA's fused QKV projection,
        # and with quant_bits=4 the int4 decode copies (on the int8 model,
        # after its int8 traces).
        engine = InferenceEngine(config, model, quant_bits=bits,
                                 quant_matmul=args.quant_matmul, moe_mode=args.moe_mode)
        for rows, length in ((64, 32), (4, 64)):
            ids = torch.randint(4, config.vocab_size, (rows, length), generator=gen,
                                device=dev)
            mask = torch.ones((rows, length), dtype=torch.int32, device=dev)
            last = torch.full((rows,), length - 1, device=dev)
            cache_kw, step_kw = {}, {}
            if args.mha:
                # The last slot of a prompt + 64 cache, every slot valid.
                t = length + 63
                cache_kw = dict(max_length=t + 1, kv_int8=engine.kv_int8)
                step_kw = dict(t=t, positions=torch.full((rows,), t, device=dev))
            _trace(f"{kind} prefill {rows} x {length}",
                   lambda: model.prefill(model.init_cache(rows, **cache_kw), ids, mask,
                                         logit_positions=last), 3, card)
            cache = model.init_cache(rows, **cache_kw)
            model.prefill(cache, ids, mask, logit_positions=last)
            tok = ids[:, -1]
            _trace(f"{kind} decode step, {rows} rows",
                   lambda: model.decode_step(cache, tok, **step_kw), 5, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
