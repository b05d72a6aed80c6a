#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. identify the card and the toolchain (nvidia-smi, torch, CUDA, nvcc,
     Triton);
  2. build the port's CUDA kernels from ``apertis_llm_torch/csrc`` with nvcc
     (one process per source, all started together);
  3. build the 1.5B text-only selective-SSM model on the card from a seeded
     generator, with seeded noise on every norm weight and bias, FFN bias and
     skip weight D (their init values 1 and 0 would hide a kernel that
     dropped them): in bf16, and with int8 weights from ``quantize_params``
     run on the card. Show that the kernel checks can see each of those terms
     and each int8 scale (the plain version without it differs by more than
     the tolerance); then hold each kernel against its plain PyTorch version
     on the card, at the shapes the requests below give it, at a ragged size
     and in every variant its wrapper accepts (RMSNorm, ffn_mode "none", f32
     scan operands, ReLU and SiLU, several hidden tiles), and time both with
     CUDA events beside the kernel's bound; the int8 and the bf16 decode
     step in every ffn_mode with both norms, and the int8 and int4 decode
     FFN at I = 9728 and 1536 with GELU, ReLU and SiLU, at 4, 5, 64 and 256
     rows, each run twice for the same bits (the bf16 step and the bf16
     decode FFN twice at 64 rows); their warm and cold times
     (``decode_times``: one layer's weights again and again, or each of the
     model's 20 layers in turn; the bf16 step's and FFN's over the bf16
     model's) and each of their launches' registers, shared memory and
     local bytes; the fused norm + quantize (``ln_quantize``, #5) at the
     main path's shapes (LN_SHAPES: request B's 2048 x 2432 with either
     norm, request A's 256 rows, the MoE mixer's D = 704, the int8 ViT's
     12,608 x 768 LayerNorm with bias at eps 1e-5, a ragged 37 rows) and at
     the widths 192, 1216, 2432, 2436 and 2431 (vectors of 4 and of 1) and
     32,768 (the widest it takes) with both norms, each twice for the same
     bits, with each plan's registers and shared memory, and that a wider
     row raises; #7 at the int8 ViT's products (12,608 rows, K = 768 with
     N = 2304, 768 and 3072, K = 3072 with N = 768);
     Then the same for the 1.5B top-2-of-8 MoE model (hidden 704, 44 layers,
     experts of 2816): the scan, ``ln_quantize`` and the decode step at its
     mixer's shapes (D = 704, C = 176, R = 44, H = 11), the step's moe
     epilogue in both layouts at 4, 5, 64 and 256 rows (x_param's bf16 rows
     of 792 bytes staged by the producer's own loads; warm and cold over
     the 44 layers, ``moe_step_times``), the fat expert kernel (twice at 64
     rows for the same bits; its warm and cold times over the 44 layers' fat stacks
     with each layer's own routing, ``fat_times``) and the grouped expert
     kernel (at 2048 and 37 tokens, each twice for the same bits, and
     whether it is bit-equal to its plain version), with sensitivity checks
     for the combine weights, b1t, w1t_s, w2t_s, the router bias and the
     epilogue's inverse deviation, and the
     bf16 moe epilogue's combine weights at 256 rows over FAULT2_SEEDS more
     seeds;
     Then the 1.5B MHA model (hidden 2432, 20 layers, 38 heads of 64, q/k/v/o
     biases), bf16 and int8: the decode-attention kernel over a bf16 and an
     int8 cache at the caches of the requests below, at bench.py's 256-slot
     allocation, at 2048 slots and at head widths 32, 96, 128 and 192, with ragged
     masks that exclude the stale slot, and the causal flash-attention
     forward at L = 128, 300, 1024 and Dh = 128, with sensitivity checks
     (the self-term, the mask, ks, vs, qs; the causal mask) and
     ``scaled_dot_product_attention`` timed beside both as the library
     yardstick;
     Then w4a8 serving's kernels: the w8a8 product (``quant_matmul_dyn``,
     every int8 linear) at the 1.5B prefill shapes (2048 rows), at the int8
     head (64 x 2432 x 32000), at ragged rows and at N = 44 and 396, in bf16
     and f32 out, bit-equal to its plain version, with ``torch._int_mm`` on
     the same operands timed as the library yardstick; the decode FFN's int4
     layout at the 1.5B widths; and the fat MoE kernel's int4 layout at the
     3B MoE preset's widths (hidden 768, 74 layers, experts of 3072, built
     here in int8 and served with int4 fat stacks; twice at 64 rows for the
     same bits, warm and cold over COLD_INT4_LAYERS of its fat stacks), each
     with sensitivity checks (the shifts, the scales, the biases) that must
     move the plain output by 9 tolerances;
     Then the selectable int8 arithmetic's kernels (phase 3f): the
     weight-only product (``quant_matmul``, ``quant_matmul="pallas"``) and
     the block-quantizing one (``quant_matmul_dyn_fused``, ``"fused"``,
     bit-equal) at the 1.5B FFN's w1 at 64 and 2048 rows, the int8 head at
     4 rows, x_param_proj at 300 rows (K = 608) and N = 44, in bf16 and f32
     (#8 also at 16 and 128 rows and on w2, K = 9728, at 4, 17 and 64 rows,
     where its plan splits K over a cluster; a second run bit for bit at
     2048 x 2432 x 9728 and at the split; each plan's resources), with
     ``x @ w_deq`` (the weight dequantized to bf16 ahead of the call) timed
     as #6's library yardstick; then #7 and #6 with bf16 x alone
     (``qmm_phase``, seeded operands at the models' shapes): every tile plan
     (row tiles 16 to 256, a K split over a cluster, each TMA variant, N =
     44, K = 597 and 4001) against the plain versions, a second run bit
     for bit at 2048 x 2432 x 9728, at N = 44 and at a K split over a
     cluster, each plan's registers, shared
     memory and resident blocks an SM, and the times at the decode shapes
     (the int8 head at 64 and 4 rows, the MHA model's fused QKV at 64, #6
     on w1 at 64; #8 at 2048 x 2432 x 9728 and on the head at 64 and 4
     rows) beside their bounds and ``torch._int_mm`` on the
     row-major weight and on a column-major copy; the per-expert MoE kernel
     (``expert_ffn_dense``, ``moe_mode="kernel"``) at the 1.5B MoE widths at
     S = 4, 5, 64 and 256, bf16 and f32 out, each activation, twice at 64
     and 256 rows for the same bits; each with sensitivity checks (the scales, the
     biases, #8's per-block scales) that must move the plain output by 9
     tolerances;
     Then the image prefix's shapes (phase 3h): the decode attention over
     the MHA caches behind 197 image tokens (request A's 288 slots at 4
     rows, request B's 296 at 64, bf16 and int8), the bf16 and f32 flash
     forward, dQ and dK/dV at (4, 38, 709, 64) and the scan's forward (every
     state) and backward at (4, 709, 38, 16): multimodal training's 197
     image and 512 text positions;
  4. serve two batches through ``InferenceEngine.generate`` with the dense
     bf16 and int8 models, the MoE bf16 and int8 models and the MHA bf16
     (bf16 KV cache) and int8 (int8 KV cache) models (4 ragged
     prompts of 7/19/32/45 tokens, greedy, 24 new tokens, one EOS id; 64
     prompts of 32 tokens, greedy, 64 new tokens), with every kernel's launch
     counter set to 0 just before each model's requests and checked just
     after (layers x calls; for MoE the fat kernel at every decode step and
     at request A's 256-row prefill, the grouped kernel at request B's
     2048-row prefill; for MHA the decode-attention kernel at every decode
     step and no flash launch, since serving prefill carries a mask), tokens
     in range and each request repeated with the same tokens; then TTFT and
     decode tokens per second per batch; the same with the image prefix
     (bench.py's multimodal flagship: ViT-B/16 at 224, 197 tokens, and
     vision_proj, added to the models from seeded noisy trees; each request
     with seeded uint8 images of 160 x 200 and 256 x 320 pixels) for the
     dense bf16 model, the dense int8 model with a bf16 ViT and with an int8
     one (``ln_quantize`` at ln1 and ln2 of every ViT layer, #7 at its
     products), the MoE int8 model with a bf16 ViT (request A's prefill
     of 4 x 264 rows through the grouped kernel) and the MHA model, bf16
     with a bf16 ViT and a bf16 cache and int8 with an int8 ViT and an int8
     cache (caches of 197 + bucket + new-token slots, checked: 288 and
     296), exact launch counts and figures beside the text-only ones; the same for the 1.5B dense int8
     model under ``quant_matmul="pallas"`` and ``"fused"`` (every prefill
     linear and the head through #6 or #8) and the 1.5B MoE int8 model under
     ``moe_mode="kernel"`` (request A's prefill and every decode step
     through #11, request B's prefill through ``moe_ragged``), beside dyn
     and fatk in the same call, and under ``quant_matmul="auto"`` (its
     pre-norms fused by ``ops/quant.py::fuses_pre_norm``; ``auto``,
     ``fused`` and ``kernel`` with repeat identity, untimed); then, after phase 5's 1.5B
     checks, the same two requests with w4a8 serving
     (``InferenceEngine(..., quant_bits=4)``) of the 1.5B dense and MHA int8
     models (the int4 decode FFN) and of the 3B MoE model at its 74 layers
     (request A's prefill and every decode step through the int4 fat kernel,
     request B's 2048-token prefill through ``moe_ragged``), and int8 serving
     of the 500M dense preset (hidden 1216, not a multiple of 128: the FFN
     through the w8a8 product, never the decode FFN kernel), with exact
     launch counts, repeat identity, TTFT and decode tokens per second;
     then (4c) the 1.5B MHA + MoE model that ``create-model --target-params
     1.5B --expert-system`` builds (the MoE preset's widths, 11 heads of 64)
     in bf16 and int8: #9 over its request caches (4 x 88 and 64 x 96
     slots), #10 and #12 on its first fat stack, then both requests under
     the engine's defaults (``quant_matmul="auto"``, ``moe_mode="fatk"``)
     and, int8, under ``moe_mode="fat"``, with exact launch counts (#9 a
     layer and decode step, #10 a layer and step and at request A's
     prefill, #12 at request B's, #6 for every prefill linear: its
     pre-norms feed the router or q/k/v, never #5), repeat identity, and
     for int8 under the defaults TTFT and decode tokens per second; ``fat``
     against ``fatk`` on one layer's FFN within 4 bf16 ulps, and through
     the 44 layers (request A's prefill and three decode steps) ``fat``,
     ``kernel`` and ``0`` each against ``fatk`` with every logit finite,
     their errors and each layer's tokens routed to other experts reported;
     then the kernels of training: the scan forward's states (``want_h``),
     which the backward reads, over chunks of the time axis, at the 1.5B
     SSM training shape, the MoE mixer's (11 heads), ragged with a mask and
     at an L that is not a multiple of the chunk, each twice for the same
     bits; the scan backward (on the plain side from the plain
     forward's states) at the training shape (B = 4, L = 1024, 38 heads of
     16, bf16; chunks of the time axis, twice for the same bits), at a
     ragged L = 300 with a mask and an ``h_last`` cotangent, with f32
     operands and at the MoE mixer's 11 heads; flash dQ and dK/dV at (4, 38, 1024, 64), at
     L = 300 and at Dh 32, 128 and 256; with sensitivity checks (the
     ``h_last`` cotangent, the mask, the a*A and a*delta chain factors;
     ``delta``, ``lse``, the causal mask) and the backward of
     ``scaled_dot_product_attention`` timed beside flash as the yardstick;
     the scan backward at d_state 12, 24, 48 and 64 (the shared-memory head
     sum) at the training shape, masked and with an ``h_last`` cotangent,
     and f32 at N = 48; the f32 flash forward, dQ and dK/dV (split-TF32
     products on the tensor cores) at (4, 38, 1024, 64), L = 300, Dh 8, 32,
     96, 128 and 256, and non-causal at L = 300 (Dh 64 and 256), with SDPA on
     the same f32 inputs (TF32 off) timed beside them; sensitivity checks as
     above, and a second run of each new kernel giving the same bits (the
     bf16 flash forward, dQ and dK/dV too, at (4, 38, 1024, 64) and at
     L = 300; the f32 ones at (4, 38, 1024, 64) and the non-causal shapes),
     and the registers, shared memory and resident blocks per SM that the
     card gives each bf16 and f32 flash kernel;
  5. check 2-layer dense, MoE and MHA models on the card against the same
     weights on the CPU (plain versions), bf16, int8 and w4a8 (dense and
     MoE), dense int8 under ``pallas`` and ``fused`` and MoE int8 under
     ``kernel`` (exact launch counts), a hidden-192 int8 model and an MHA
     model with heads of 96 (bf16 and int8 cache: #9 at every decode
     step), and a MoE model with 40 experts, more than the decode step's moe
     epilogue takes (bf16 and int8, and int8 through
     ``InferenceEngine.generate``: every decode step without the epilogue,
     the fat kernel once a layer and step), 2-layer dense, MoE and MHA models
     with a small image prefix, bf16 and int8 with an int8 ViT (``ln_quantize``
     launched once a pre-norm and ViT norm; for MHA the cache holds the
     prefix and #9 runs once a layer and step), and the variants beside
     the presets in bf16 and int8, with the CPU's greedy tokens (except on
     a near-tie within the tolerance): MHA with a MoE FFN (int8 also under
     ``moe_mode="fat"``), SwiGLU with either mixer, absolute positions with
     an untied head (either mixer, MHA also behind the prefix), top-1 and
     top-3 MoE (every decode step without the moe epilogue), MHA at head
     widths 48 and 320 (the plain decode attention, no #9); that the 1.5B
     logits are finite, that
     the 1.5B MHA ``forward()`` without a mask runs the flash kernel once per
     layer and agrees with the plain attention, that a 2-layer f32 flash
     MHA ``forward()`` runs the f32 flash kernel once per layer and agrees
     with the CPU, and that a 2-layer f32 MoE ``forward()`` with no engine
     (``moe_dense`` and ``moe_ragged`` in f32) launches no expert kernel and
     agrees with the CPU; the 2-layer MoE models of the card-vs-CPU checks
     get their serving stacks attached as the engine attaches them;
  6. train, with the serving models freed: the 1.5B dense SSM preset, the
     1.5B MoE preset with its default MoE knobs (capacity factor 1.25, noisy
     routing 0.1, expert dropout 0.1, lb 0.01, rz 0.001) and the 1.5B MHA
     preset with ``use_flash_attention`` (dropout 0, as bench.py), in bf16
     compute, and the MHA preset again in f32 compute (``bf16=False``), each
     through ``ApertisTrainer.train()`` with f32 masters, remat and
     accumulation over 2, 8 micro-batches of 4 x 1024 seeded token ids (4
     updates), then the 1.5B dense SSM and MHA flash presets with the
     ViT-B/16 prefix in bf16 on 8 micro-batches of 4 x 512 text tokens
     behind 197 image tokens, checking that the loss is finite and falls, that the step
     metrics' lb_loss and rz_loss are finite and positive for MoE (zero
     otherwise), and that the scan (forward 2 x layers x micro-steps under
     remat, backward layers x micro-steps) or flash kernels of the compute
     dtype (the same for the forward, dQ and dK/dV) ran and no expert kernel
     did; then ``train_from_config`` on a 2-layer SSM config from a JSONL
     corpus and ``vocab.json`` written here, its checkpoint and a resume from
     it; then one train step's gradients of 2-layer models on the card
     against the same step on the CPU: SSM at d_state 16 and 12 and flash
     MHA in bf16 compute, each leaf within two bf16 ulps plus twice bf16's
     own effect on it (the CPU's bf16 vs f32 step); MoE (no step seed, a
     capacity that drops tokens) and flash MHA in f32 compute, each leaf
     within 1e-4 of its largest CPU value; and the same for the SSM, MoE and
     flash MHA models behind a small image prefix (the ViT's leaves too);
     then (6b) a checkpoint round trip: a 2-layer model at the 1.5B MHA
     widths with the ViT-B/16 prefix, bf16 on the card, written with
     ``save_torch_checkpoint`` and read back with ``load_pretrained`` on
     the card from the directory and from the bare weights file, whose
     logits with images must be bit-equal to the writer's and whose greedy
     tokens with images the writer's;
  7. parallel training, after phase 3g's check of the carried-state scan
     (#2, forward and backward over chunks of the time axis, against its
     plain versions at the 1.5B model's (4, 38, 1024, 16) and a rank's (4,
     38, 512, 16), from zero and from an ``h_init``, and at L = 300 (the
     forward also with b in bf16 and its f32 states, each twice for the
     same bits); the forward bit-equal where L fits one chunk; with
     sensitivity checks for ``h_init`` and the ``h_last`` cotangent): two
     ranks started with
     ``apertis_llm_torch.parallel.spawn`` share the card in a gloo process
     group (NCCL does not put two ranks on one card) and run the
     sequence-parallel scan on (4, 38, 1024, 16) (h within 1e-5, gradients
     within 1e-4 of one rank's ``selective_scan``), one step of a 2-layer
     f32 dense-SSM model on meshes (1, 1, 1, 2) and (2, 1, 1, 1) (loss within
     1e-5, each gradient leaf within 1e-4 of one process on the card; after
     two updates the ranks' parameters hash the same), and the 1.5B dense
     preset trained on (1, 1, 1, 2) for 4 micro-steps of the global 4 x 1024
     (accumulation 2, remat, bf16 compute): #2's launches counted per rank
     (2 scans a layer, the forward twice under remat) and #1's none, the
     loss finite and falling, its first value within one bf16 ulp of the
     same run in this process, the micro-step p50, the gradient
     all-reduce's share and each rank's peak memory;
  8. the user-facing surfaces (``surfaces_phase``), after phase 3i's checks
     of the decode kernels' f32 forms (``f32_forms_phase``: #3, #4, #5 and
     #9 on an f32 layer at the 1.5B widths and its int8 quantization, at 64,
     4 and 1 rows, with sensitivity checks and repeat bits): ``apertis_llm_
     torch.cli``'s ``create-model`` writes the 1.5B dense model, ``chat``
     serves it in f32 and in int8 from stdin through ``InferenceEngine.
     stream`` (exact launch counts of the f32 forms, the first turn equal
     to ``generate`` and to a repeat, TTFT and the streamed rate), ``eval``
     scores perplexity and multiple choice in both, ``train`` fine-tunes a
     2-layer model of the same widths with a resized vocabulary, 2-layer
     MoE and MHA models chat, and the UI backend chats and runs a
     fine-tuning job and an AZR job with gradio stubbed.
Kernel times are CUDA-event means over back-to-back wrapper calls ("ms")
and the profiler's device time per call ("device_ms", the kernels' own time
without the Python wrapper, from each kernel's mean duration in the
profiler's records, which can miss some launches). Before the last line it
prints the bf16 and f32 flash kernels' resources, #7's, #6's and #8's times,
#7's and #6's resources and host enqueue times (``{"qmm": ...}``), the decode
kernels' times and resources (``{"decode_times": ...}``: #3 int8 and bf16,
each with the dense and the moe epilogue, #4 bf16, int8 and int4, #10 int8
and int4, #11), the kernels' JSON summary (#1's forward also at the two
training shapes, under "other_shapes") and the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py --qmm          # #7 and #6 alone: checks, repeats, resources,
                                         # times, and other tile plans' times
    python3 chip_smoke.py --qmm-times    # their times alone, and #8's
    python3 chip_smoke.py --flash-f32-times  # the f32 flash kernels' times and SDPA f32's
                                             # at (4, 38, 1024, 64), and the 1.5B MHA
                                             # model's f32 micro-step p50
    python3 chip_smoke.py --decode-times     # the int8 and bf16 decode step's (dense
                                             # and moe epilogues), the bf16, int8 and
                                             # int4 decode FFN's, the int8 and int4
                                             # fat MoE FFN's and the per-expert MoE
                                             # FFN's warm and cold times at 64 and 4 rows
    python3 chip_smoke.py --scan-fwd-times   # the scan forwards' times: #1 at request
                                             # A's and B's prefill (B with and without
                                             # its all-ones mask) and the dense and
                                             # MoE-mixer training shapes, #2 at (4, 38,
                                             # 512 and 1024, 16), f32 and bf16; with
                                             # other chunks where the checkout has them
    python3 chip_smoke.py --scan-bwd-times   # the scan backward's times at the 1.5B
                                             # training shape, N = 12 and 11 heads, and
                                             # #2's backward at (4, 38, 512 and 1024, 16)
                                             # with other chunks
    python3 chip_smoke.py --grouped-times    # the grouped MoE FFN's (#12) at 2048 and
                                             # 37 tokens, and at both row tiles
    python3 chip_smoke.py --ln-times         # the fused norm + quantize's (#5) at
                                             # LN_SHAPES, and at other threads a row
    python3 chip_smoke.py --auto-times       # the int8 linear's three forms (dyn: row
                                             # quantization + #7; #6; weightonly) at
                                             # 1-16,384 rows on seven products: the
                                             # table behind quant_matmul="auto"
    python3 chip_smoke.py --surfaces         # phases 3i and 8 alone
    python3 chip_smoke.py --auto-model-times # the 1.5B int8 models' prefill at 64-4,096
                                             # rows with auto's pre-norms fused (#5 +
                                             # #7) and not (#6), and dyn: the
                                             # threshold AUTO_DYN_ROWS

The first two flags run ``qmm_phase`` only. ``--qmm-times``,
``--flash-f32-times``, ``--decode-times``, ``--scan-fwd-times``,
``--scan-bwd-times``, ``--grouped-times``, ``--ln-times``, ``--auto-times`` and
``--auto-model-times`` need nothing of the checkout but the wrappers' (and the trainer's) Python
interface, so a checkout of an
earlier commit can run them with this script copied into it, for a
comparison in one call.

It needs a CUDA device and exits non-zero without one. It imports no JAX.
"""

import collections
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_ULP = 2.0 ** -7      # one bf16 ulp relative to the largest value
F32_TOL = 1e-3            # f32 outputs computed from bf16-rounded operands
SCAN_F32_TOL = 1e-4       # f32 carry; op fusion differs per step
SCALE_TOL = 1e-6          # int8 row scales of ln_quantize (same formula, f32)
INT8_MAX_DQ = 1           # int8 outputs: a level may flip by one ...
INT8_FLIP_SHARE = 1e-3    # ... for under this share of the elements
NOISE_STD = 0.1           # seeded noise on norms, biases and D
# flash_attention_fwd: P V runs on the tensor cores with p rounded to bf16
# (2^-9 of each term), where the plain version keeps p in f32, and then the
# output is rounded to bf16 itself: up to two bf16 ulps at the top.
FLASH_TOL = 2 * BF16_ULP
LSE_TOL = 1e-5            # f32 log-sum-exp; exact bf16 products summed in another order
# The 1.5B MHA forward through the flash kernel vs through the plain
# attention: 20 layers, each attention output up to two bf16 ulps apart,
# feeding a bf16 residual stream (the 2-layer card-vs-CPU checks used a
# quarter of a 4-ulp limit).
FLASH_FORWARD_TOL = 8 * BF16_ULP
# The scan's backward, f32 outputs (d_delta, dA and f32 dB, dC): the reverse
# recursion with fused multiply-adds in the kernel against separate products
# in the plain version, over up to 1024 steps, and dA's sum over the (b, t)
# partials in another order. bf16 dB and dC: one bf16 ulp.
SCAN_BWD_TOL = 1e-4
# Flash dQ, dK, dV: p and ds are rounded to bf16 before the tensor-core
# products (the plain version keeps them in f32), then each output is rounded
# to bf16 itself: up to two bf16 ulps at the top, as for the forward.
FLASH_BWD_TOL = 2 * BF16_ULP
# One train step of a 2-layer model, card vs CPU, both in bf16 compute with
# f32 masters. Each gradient leaf within two bf16 ulps of its largest
# element, plus twice what bf16 compute itself does to that leaf (its max
# difference between the CPU's bf16 and f32 runs): the card and the CPU each
# carry a bf16 rounding noise of about that size, placed differently (the
# kernels' tensor-core products with p and ds in bf16, cuBLAS against the
# CPU's matmuls). That noise dominates a leaf whose exact gradient is small
# next to it, such as the q and k weights of the 2-layer MHA model at random
# init (near-uniform attention); a well-conditioned leaf is held to about the
# two ulps. The loss within one ulp.
SMALL_GRAD_TOL = 2 * BF16_ULP
TRAIN_LR = 5e-4           # the 1.5B training phase's peak learning rate
MM_PREFIX = 197           # ViT-B/16's tokens at 224 pixels: 14 x 14 patches and CLS
# quant_matmul_dyn against its plain version: exact int32 sums, then the same
# f32 products acc * x_s * w_s in the same order, one rounding to the output
# type and the bias added in it: bit-equal.
QMM_TOL = 0.0
# quant_matmul (#6) with f32 x against its plain version: the products of f32
# x with int8 levels are rounded in f32 on both sides and summed in another
# order (the kernel's fused multiply-adds along K against cuBLAS's f32 sums,
# TF32 off), over up to 9728 terms. bf16 x: every product is exact in f32,
# only the order of the f32 sums differs, then one rounding to bf16: one
# bf16 ulp (BF16_ULP). quant_matmul_dyn_fused (#8): bit-equal (QMM_TOL), as
# #7. expert_ffn_dense (#11): one bf16 ulp, the fat kernel's rule (a hidden
# value on an int8 rounding boundary may flip a level).
QMM_F32_TOL = 3e-5
# A sensitivity check of the w8a8 and int4 kernels must move the plain output by
# this many tolerances (0 for the bit-equal product: any move).
SENSITIVITY_FACTOR = 9
# The int4 decode FFN's b2 check runs at this multiple of the layer's b2.
B2_SENSITIVITY_SCALE = 8
# A 2-layer f32 MHA forward on the card (cuBLAS f32, TF32 off) vs the CPU:
# f32 sums in other orders.
F32_FORWARD_TOL = 1e-4
# The f32 flash kernels against their plain versions: the kernels' split-TF32
# products (hi * hi + hi * lo + lo * hi of TF32 parts, about 2^-22 of each
# term) against cuBLAS's f32 products (TF32 off), the same products summed in
# other orders over up to Dh or L terms (about sqrt(L) * 2^-24 of the largest
# term), and the forward's online softmax rescaling.
F32_FLASH_TOL = 1e-5
# The carried-state scan (#2) against its plain versions: JAX's own bounds
# (tests/test_pallas_kernels.py:69-78), relative to the largest element;
# both sides round each product and sum once, the forward in one order; the
# backward runs over chunks of the time axis, whose carries reassociate the
# adjoint's sums (about an f32 ulp of lam a chunk boundary).
CARRY_TOL = 1e-5
CARRY_BWD_TOL = 1e-4
# A 2-layer f32 train step's loss on a two-rank mesh vs one process on the
# card: the same f32 sums, the token losses summed in chunks.
F32_SP_LOSS_TOL = 1e-5
# The 1.5B preset's first micro-step loss on mesh (1, 1, 1, 2) vs the same run
# in one process (bf16 compute): one bf16 ulp of the loss. The two runs differ
# by where bf16 rounds (cuBLAS picks its kernels by row count, 2048 rows a
# rank against 4096; the chunked scan adds f32 roundings; the SP route casts
# b to f32 before the scan), each token's loss carries a bf16 noise of about
# an ulp of its logits, of either sign, and the mean over 4096 tokens keeps
# well under one ulp of the loss itself.
PARALLEL_LR = 5e-3        # the 1.5B mesh run's peak learning rate
# One f32 train step of a 2-layer model, card vs CPU (the MoE model, whose
# top-2 choice would flip on a near-tie under bf16 rounding, and the f32
# flash MHA model): each gradient leaf within 1e-4 of its largest CPU value.
F32_GRAD_TOL = 1e-4
# The decode kernels' f32 forms (phase 3i): f32 sums in another order than
# the plain version's, relative to the largest value of each output; their
# int8 forms' f32 outputs move by a level where a row's quantization
# rounds the other way, as the int8 layouts' bf16 outputs do (BF16_ULP).
F32_FORM_TOL = 1e-4
# The f32 forms: their sources and the TPU kernels they replace.
F32_FORMS = {
    "ssm_decode_step_f32": ("apertis_llm_torch/csrc/ssm_step.cu",
                            "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
    "ssm_decode_step_int8_f32": ("apertis_llm_torch/csrc/ssm_step.cu",
                                 "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
    "ffn_decode_f32": ("apertis_llm_torch/csrc/ffn_fused.cu",
                       "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
    "ffn_decode_int8_f32": ("apertis_llm_torch/csrc/ffn_fused.cu",
                            "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
    "mha_decode_ctx_f32": ("apertis_llm_torch/csrc/mha_step.cu",
                           "apertis_llm_tpu/ops/pallas/mha_step.py:131"),
    "mha_decode_ctx_int8_f32": ("apertis_llm_torch/csrc/mha_step.cu",
                                "apertis_llm_tpu/ops/pallas/mha_step.py:131"),
    "ln_quantize_f32": ("apertis_llm_torch/csrc/ln_quant.cu",
                        "apertis_llm_tpu/ops/pallas/ln_quant.py:60"),
}
# The card's published peaks (NVIDIA H100 SXM data sheet, dense). The f32
# flash kernels' products run on the tensor cores in split TF32: three TF32
# products for each f32 one, so their operations count 3x against "tf32".
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}


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


def device_ms(fn, iters=10, tries=3, by_kernel=False):
    """The device time of one call of ``fn``: the profiler's CUDA activity
    (kernels and memsets) over ``iters`` back-to-back calls, per call. The
    profiler can lose activity records of the kernels launched through
    ctypes (9, or even 2, of 10 seen on the card), so the time is each
    activity name's mean duration times its launches per call (its records
    over ``iters``, rounded up), not the records' sum over ``iters``. A
    window with no record is taken again, up to ``tries`` windows; None if
    the profiler saw no device activity in any. With ``by_kernel``, the
    time of each activity name instead ({name: ms a call})."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, counts = collections.defaultdict(float), collections.Counter()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us[ev.name] += ev.time_range.elapsed_us()
                counts[ev.name] += 1
        if not counts:
            continue
        if any(c % iters for c in counts.values()):
            log(f"  device_ms: the profiler kept {sorted(counts.values())} records of "
                f"{iters} calls; each kernel's mean duration times its launches per call")
        per = {n: us[n] / counts[n] * -(-counts[n] // iters) / 1e3 for n in counts}
        return per if by_kernel else sum(per.values())
    return None


def graph_ms(fn, calls=10, replays=10):
    """Milliseconds a call of ``fn`` when ``calls`` calls are captured into
    one CUDA graph and replayed: the device's time for the calls' launches
    back to back, gaps between launches included, without the host's
    enqueue time. None if the calls cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        log(f"  graph_ms: the calls could not be captured ({exc})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops, kind):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mha_preset_config(dims):
    """The 1.5B MHA preset (bench.py's arch="mha") at the widths `dims` of
    ``calculate_model_dimensions("1.5B", 32000)``: 38 heads of 64, q/k/v/o
    biases, dropout 0."""
    from apertis_llm_torch.config import ApertisConfig
    return ApertisConfig(
        vocab_size=32000, attention_type="standard_mha", ssm_d_state=16,
        hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=4096,
        dtype="bfloat16", param_dtype="bfloat16")


def f32_flash_cost(shape, products):
    """(bytes, operations, type) of an f32 flash kernel at (B, H, L, Dh),
    causal: q, k, v (and dout) read and the outputs written once, plus lse
    (and delta), each f32; `products` products of 2 Dh flops over the causal
    half of the pairs, each run as three TF32 products (split TF32)."""
    b, h, l, hd = shape
    pairs = b * h * l * (l + 1) // 2
    tensors = {2: 4, 3: 5, 4: 6}[products]   # q k v out | q k v do dq | q k v do dk dv
    vectors = {2: 1, 3: 2, 4: 2}[products]   # lse | lse delta
    return (tensors * b * h * l * hd * 4 + vectors * b * h * l * 4,
            3 * products * 2 * hd * pairs, "tf32")


def sdpa_f32_ms(qkv, dout):
    """The library yardsticks of the f32 flash kernels on the same inputs:
    scaled_dot_product_attention(is_causal=True) and its backward alone (its
    graph kept; dQ, dK and dV in one call), the least of three windows each."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = min(cuda_ms(lambda: sdpa(*qkv, is_causal=True)) for _ in range(3))
    leaves = [t.detach().requires_grad_(True) for t in qkv]
    out = sdpa(*leaves, is_causal=True)
    bwd = min(cuda_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
              for _ in range(3))
    return fwd, bwd


def compare(name, got, ref, rel_tol):
    """Max abs error of got vs ref (in f32); raise past rel_tol * max|ref|."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    bound_ = rel_tol * float(ref.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= bound_
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound_:.3e} = {rel_tol:.2e} x max|ref|)"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def compare_int8(name, got, ref, _tol=None):
    """int8 outputs: at most INT8_MAX_DQ levels apart, on under
    INT8_FLIP_SHARE of the elements (the JAX package's tolerance for its
    quantizing kernels). Returns the largest level difference."""
    if got.shape != ref.shape or got.dtype != torch.int8:
        raise RuntimeError(f"{name}: {got.dtype} {tuple(got.shape)} vs {tuple(ref.shape)}")
    dq = (got.int() - ref.int()).abs()
    worst, share = int(dq.max()), float((dq > 0).float().mean())
    ok = worst <= INT8_MAX_DQ and share < INT8_FLIP_SHARE
    log(f"  {name}: max |dq| {worst}, {share:.2e} of the levels differ (tolerance "
        f"{INT8_MAX_DQ} level on < {INT8_FLIP_SHARE:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return float(worst)


class TokenRows(list):
    """An in-memory dataset of token-id items of one length; the trainer
    reads ``max_length`` for its tokens per step."""

    def __init__(self, items, max_length):
        super().__init__(items)
        self.max_length = max_length


def perturb_(tree, generator):
    """Add seeded noise to every norm weight and bias, FFN bias and skip
    weight D of a parameter tree, to the MoE router's LayerNorm and bias and
    the experts' LayerNorms and biases, to MHA's q/k/v/o biases and to the
    ViT's LayerNorms and biases (and vision_proj's), which init_params sets
    to 1 or 0, so that every term the kernels compute has a value that shows
    when it is dropped."""
    def walk(node, path):
        for key, value in node.items():
            name = f"{path}.{key}"
            if isinstance(value, dict):
                walk(value, name)
                continue
            is_norm = "norm" in name or "router_ln" in name
            moe_term = ((".router" in name and key == "b")
                        or (".experts" in name and key in ("ln_w", "ln_b", "b1", "b2")))
            mha_bias = key == "b" and path.rsplit(".", 1)[-1] in ("q", "k", "v", "o")
            vit_term = name.startswith(".vision") and (
                key in ("b", "in_proj_b") or path.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_ln"))
            if (is_norm or moe_term or mha_bias or vit_term or key == "D"
                    or (".ffn.w" in name and key == "b")):
                noise = torch.randn(value.shape, generator=generator, device=value.device)
                scale = 5 * NOISE_STD if key == "D" else NOISE_STD
                value.add_((noise * scale).to(value.dtype))
    with torch.no_grad():
        walk(tree, "")


def to_numpy(tree):
    """A parameter tree of tensors as numpy arrays (what the ranks are sent)."""
    return {k: to_numpy(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


# ---- the int8-weight GEMMs #7 and #6 (bf16 x) --------------------------------

# The timed shapes (kernel, label, M, K, N): the 1.5B FFN's w1 at 2048
# prefill rows; at decode rows the int8 head (2432 x 32000) at 64 and 4, the
# MHA model's fused int8 QKV (2432 x 7296) at 64, and #6 on w1 at 64; #8 on
# w1 at 2048 and the int8 head at 64 and 4.
QMM_TIMED = [
    ("quant_matmul_dyn_pre_q", "1.5B FFN w1 at 2048 rows", 2048, 2432, 9728),
    ("quant_matmul_dyn_pre_q", "int8 head at 64 rows", 64, 2432, 32000),
    ("quant_matmul_dyn_pre_q", "int8 head at 4 rows", 4, 2432, 32000),
    ("quant_matmul_dyn_pre_q", "1.5B MHA fused QKV at 64 rows", 64, 2432, 7296),
    ("quant_matmul", "1.5B FFN w1 at 2048 rows", 2048, 2432, 9728),
    ("quant_matmul", "1.5B FFN w1 at 64 rows", 64, 2432, 9728),
    ("quant_matmul_dyn_fused", "1.5B FFN w1 at 2048 rows", 2048, 2432, 9728),
    ("quant_matmul_dyn_fused", "int8 head at 64 rows", 64, 2432, 32000),
    ("quant_matmul_dyn_fused", "int8 head at 4 rows", 4, 2432, 32000),
]
# Shapes (M, K, N) that reach each row tile, the split and each TMA
# variant: N = 44 and K = 597 or 4001 rows are not whole 16-byte units.
QMM_SHAPES = [(2048, 2432, 9728), (2048, 9728, 2432), (300, 704, 704), (100, 2432, 2432),
              (64, 2432, 32000), (4, 2432, 32000), (64, 2432, 7296), (64, 9728, 2432),
              (1, 2432, 2432), (37, 608, 44), (17, 597, 44), (33, 597, 64), (2048, 608, 44),
              (17, 4001, 44)]


def qmm_operands(kind, m, k, n, gen, dev, out_dtype=torch.bfloat16, bias=True):
    """Seeded operands of #7 (rows quantized by ``quantize_rows``) or #6
    (bf16 x) against a weight quantized by ``quantize_weight``."""
    from apertis_llm_torch.models.quantize import quantize_weight
    from apertis_llm_torch.ops.quant import quantize_rows

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    w_q, w_s = quantize_weight(randn(k, n, std=0.05))
    b = randn(n, std=0.1).to(out_dtype) if bias else None
    if kind == "quant_matmul_dyn_pre_q":
        x_q, x_s = quantize_rows(randn(m, k))
        return (x_q, x_s, w_q.contiguous(), w_s, b, out_dtype)
    return (randn(m, k), w_q.contiguous(), w_s, b)


# Other tile plans than tile_plan's, timed by ``--qmm`` to show why it
# chooses as it does: (kernel, M, K, N, [(rows, split), ...]).
QMM_ALTERNATIVES = [
    ("quant_matmul_dyn_pre_q", 2048, 2432, 9728, [(64, 1), (128, 1), (256, 1)]),
    ("quant_matmul", 2048, 2432, 9728, [(64, 1), (128, 1), (256, 1)]),
    ("quant_matmul_dyn_pre_q", 64, 2432, 7296, [(64, 1), (64, 2), (64, 3), (64, 4)]),
    ("quant_matmul", 64, 2432, 7296, [(64, 1), (64, 2), (64, 3), (64, 4)]),
    ("quant_matmul_dyn_pre_q", 64, 9728, 2432, [(64, 1), (64, 2), (64, 3), (64, 4)]),
    ("quant_matmul_dyn_pre_q", 64, 2432, 2432, [(64, 1), (64, 2), (64, 3), (64, 4)]),
]


def qmm_alternatives(card, gen, dev):
    """Device time of each plan in QMM_ALTERNATIVES, launched through the C
    entry points with that plan; #7's outputs bit-equal to the plain
    version's at every plan. Returns {label: {plan: ms}}."""
    from apertis_llm_torch.ops.kernels import _build
    from apertis_llm_torch.ops.kernels import quant_matmul as qm
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for kind, m, k, n, plans in QMM_ALTERNATIVES:
        args = qmm_operands(kind, m, k, n, gen, dev, bias=False)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {}
        for rows, split in plans:
            if kind == "quant_matmul_dyn_pre_q":
                x_q, x_s, w_q, w_s = args[:4]
                call = lambda: lib.apertis_quant_matmul_dyn(   # noqa: E731
                    x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None,
                    out.data_ptr(), m, n, k, 1, rows, split, 1, 1, stream)
            else:
                x, w_q, w_s = args[:3]
                call = lambda: lib.apertis_quant_matmul(   # noqa: E731
                    x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None, out.data_ptr(), m, n,
                    k, 1, rows, split, 1, 1, stream)
            _build.check(call(), kind)
            torch.cuda.synchronize()
            if kind == "quant_matmul_dyn_pre_q" and not torch.equal(
                    out, qm.quant_matmul_dyn_pre_q_reference(*args)):
                raise RuntimeError(f"{kind} M={m} K={k} N={n} at rows {rows}, split {split}: "
                                   "not bit-equal")
            row[f"rows {rows} split {split}"] = device_ms(call)
        label = f"{kind} M={m} K={k} N={n}"
        result[label] = row
        chosen = qm.tile_plan(m, n, k, 1 if kind == "quant_matmul_dyn_pre_q" else 2, sms)
        log(f"  plans of {label} (device ms; tile_plan takes rows {chosen.rows} split "
            f"{chosen.split}): "
            + ", ".join(f"{p} {t:.4f}" if t is not None else f"{p} not measured"
                        for p, t in row.items()) + f"; card: {card}")
    return result


def qmm_phase(card, check=True, alternatives=False):
    """#7 and #6 with bf16 x, alone: with ``check``, each against its plain
    version at QMM_SHAPES (#7 bit-equal in bf16 and f32 out, #6 within one
    bf16 ulp), a second run bit for bit at 2048 x 2432 x 9728, at N = 44
    and at a K split over a cluster, and the resources of every tile plan;
    then the times at QMM_TIMED (#8's too) beside their bounds and the
    library call;
    with ``alternatives``, the device times of other tile plans
    (qmm_alternatives). Returns {"times": ..., "resources": ..., "plans":
    ...}."""
    from apertis_llm_torch.ops.kernels import quant_matmul as qm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    kernels = {"quant_matmul_dyn_pre_q": (qm.quant_matmul_dyn_pre_q,
                                          qm.quant_matmul_dyn_pre_q_reference),
               "quant_matmul": (qm.quant_matmul, qm.quant_matmul_reference)}
    resources = {}
    if check:
        for m, k, n in QMM_SHAPES:
            plans = {b: qm.tile_plan(m, n, k, b, torch.cuda.get_device_properties(0)
                                     .multi_processor_count) for b in (1, 2)}
            for kind, (kernel, plain) in kernels.items():
                outs = (torch.bfloat16, torch.float32) if kind == "quant_matmul_dyn_pre_q" \
                    else (torch.bfloat16,)
                plan = plans[1 if kind == "quant_matmul_dyn_pre_q" else 2]
                for out_dtype in outs:
                    args = qmm_operands(kind, m, k, n, gen, dev, out_dtype, bias=m % 2 == 0)
                    got, ref = kernel(*args), plain(*args)
                    torch.cuda.synchronize()
                    label = (f"{kind} M={m} K={k} N={n} {str(out_dtype)[6:]} "
                             f"(rows {plan.rows}, split {plan.split}, TMA x {int(plan.tma_x)} "
                             f"w {int(plan.tma_w)})")
                    if kind == "quant_matmul_dyn_pre_q":
                        err = float((got.float() - ref.float()).abs().max())
                        if not torch.equal(got, ref):
                            raise RuntimeError(f"{label}: not bit-equal (max err {err:.3e})")
                        log(f"  {label}: bit-equal ok")
                    else:
                        compare(label, got, ref, BF16_ULP)
        for m, k, n in ((2048, 2432, 9728), (37, 608, 44), (64, 9728, 2432)):
            for kind, (kernel, _) in kernels.items():
                args = qmm_operands(kind, m, k, n, gen, dev)
                a, b_ = kernel(*args), kernel(*args)
                if not torch.equal(a, b_):
                    raise RuntimeError(f"{kind} M={m} K={k} N={n}: a second run gave other bits")
                log(f"  {kind} M={m} K={k} N={n}: a second run gives the same bits ok")
        for w8a8 in (True, False):
            for rows in qm.ROW_TILES:
                for split in ((1, qm.MAX_SPLIT) if rows <= qm.SPLIT_ROWS else (1,)):
                    key = f"{'quant_matmul_dyn_pre_q' if w8a8 else 'quant_matmul'} rows={rows} split={split}"
                    res = resources[key] = qm.quant_matmul_resources(w8a8, rows, split)
                    log(f"  resources of {key}: {res['registers']} registers a thread, "
                        f"{res['shared_bytes']} bytes of shared memory and {res['threads']} "
                        f"threads a block, {res['blocks_per_sm']} block(s) an SM, "
                        f"{res['spill_bytes']} bytes spilled")
    times = {}
    timed = dict(kernels, quant_matmul_dyn_fused=(qm.quant_matmul_dyn_fused,
                                                  qm.quant_matmul_dyn_fused_reference))
    for kind, label, m, k, n in QMM_TIMED:
        kernel, plain = timed[kind]
        args = qmm_operands(kind, m, k, n, gen, dev)
        out_bytes = m * n * 2
        b_ms, by = bound(nbytes(*(a for a in args if torch.is_tensor(a))) + out_bytes,
                         2 * m * n * k, "bf16" if kind == "quant_matmul" else "int8")
        k_ms = cuda_ms(lambda: kernel(*args))
        d_ms = device_ms(lambda: kernel(*args))
        p_ms = cuda_ms(lambda: plain(*args))
        host_ms = None   # the host's time to enqueue a call: the least of 5 windows of 20
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                kernel(*args)
            window = (time.perf_counter() - t0) / 20 * 1e3
            host_ms = window if host_ms is None else min(host_ms, window)
        torch.cuda.synchronize()
        lib = lib_cols = None
        if kind == "quant_matmul_dyn_pre_q":
            x_q, w_q = args[0], args[2]
            if m > 16:   # torch._int_mm on the H100 takes more than 16 rows only
                lib = cuda_ms(lambda: torch._int_mm(x_q, w_q))
                w_cols = w_q.t().contiguous().t()
                lib_cols = cuda_ms(lambda: torch._int_mm(x_q, w_cols))
        elif kind == "quant_matmul":
            x_, w_deq = args[0], (args[1].to(torch.bfloat16) * args[2].to(torch.bfloat16))
            lib = cuda_ms(lambda: x_ @ w_deq)
        times[f"{kind} {label}"] = {"ms": k_ms, "device_ms": d_ms, "host_ms": host_ms,
                                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                                    "library_ms": lib, "library_colmajor_ms": lib_cols}
        log(f"  {kind} {label} (M={m}, K={k}, N={n}): kernel {k_ms:.4f} ms, "
            + (f"device {d_ms:.4f} ms" if d_ms is not None else "device not measured")
            + f", host enqueue {host_ms:.4f} ms, plain {p_ms:.4f} ms"
            + f", bound {b_ms:.4f} ms ({by}), library "
            + (f"{lib:.4f} ms" if lib is not None else "none at this shape")
            + (f" (column-major weight copy {lib_cols:.4f} ms)" if lib_cols is not None else "")
            + f"; card: {card}")
    plans = qmm_alternatives(card, gen, dev) if alternatives else {}
    return {"times": times, "resources": resources, "plans": plans}


# ---- quant_matmul="auto": the crossover of the int8 linear's three forms -----

# The rows and (label, K, N) of ``--auto-times``: the 1.5B models' products
# (the MHA model's fused QKV, the FFN's w1 and w2, the int8 head) and the
# MHA + MoE model's 704-wide ones (q/k/v/o, its fused QKV, its int8 head).
AUTO_ROWS = (1, 4, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
AUTO_SHAPES = (("1.5B fused QKV", 2432, 7296), ("1.5B FFN w1", 2432, 9728),
               ("1.5B FFN w2", 9728, 2432), ("1.5B int8 head", 2432, 32000),
               ("MoE q/k/v/o", 704, 704), ("MoE fused QKV", 704, 2112),
               ("MoE int8 head", 704, 32000))


def auto_times(card):
    """The int8 linear's three forms on bf16 rows, as ``linear_int8`` runs
    them: ``dyn`` (the rows quantized by ``quantize_rows``, then #7),
    ``pallas`` (#6 on the bf16 rows) and ``weightonly`` (the weight
    dequantized in bf16, then ``x @ w``), each the CUDA-event mean of 20
    back-to-back calls with the host's enqueue (what a serving loop sees),
    at AUTO_ROWS x AUTO_SHAPES; beside them, not compared, #7 alone on rows
    quantized already (``pre_q``, what a projection fed by ``ln_quantize``
    runs) and the profiler's device time of ``dyn`` and ``pallas``. #7 is
    checked bit-equal to its plain version and #6 within one bf16 ulp at
    every point. Prints the table, each point's fastest form and, a shape,
    the fewest rows from which ``dyn`` is fastest at every larger count.
    Returns {shape: {"ms": {rows: {form: ms}}, ...}}."""
    from apertis_llm_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_dyn_pre_q, quant_matmul_reference)
    from apertis_llm_torch.ops.quant import linear_dyn, linear_pre_q_reference, linear_weightonly
    from apertis_llm_torch.ops.quant import quantize_rows

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    result = {}
    for label, k, n in AUTO_SHAPES:
        args = qmm_operands("quant_matmul", 1, k, n, gen, dev)
        w_q, w_s, b = args[1:]
        table, fastest = {}, {}
        for rows in AUTO_ROWS:
            x = (torch.randn((rows, k), generator=gen, device=dev)).to(torch.bfloat16)
            forms = {"dyn": lambda: linear_dyn(x, w_q, w_s, b),
                     "pallas": lambda: quant_matmul(x, w_q, w_s, b),
                     "weightonly": lambda: linear_weightonly(x, w_q, w_s, b)}
            if not torch.equal(forms["dyn"](), linear_pre_q_reference(*quantize_rows(x), w_q,
                                                                       w_s, b, x.dtype)):
                raise RuntimeError(f"--auto-times {label} at {rows} rows: #7 not bit-equal")
            compare(f"--auto-times {label} at {rows} rows, #6", forms["pallas"](),
                    quant_matmul_reference(x, w_q, w_s, b), BF16_ULP)
            table[rows] = {form: cuda_ms(fn) for form, fn in forms.items()}
            fastest[rows] = min(table[rows], key=table[rows].get)
            x_q, x_s = quantize_rows(x)
            table[rows]["pre_q"] = cuda_ms(lambda: quant_matmul_dyn_pre_q(x_q, x_s, w_q, w_s, b,
                                                                          x.dtype))
            for form in ("dyn", "pallas"):
                table[rows][form + " device"] = device_ms(forms[form])
        dyn_from = next((r for r in AUTO_ROWS
                         if all(fastest[s] == "dyn" for s in AUTO_ROWS if s >= r)), None)
        log(f"  auto {label} (K={k}, N={n}), ms dyn / pallas / weightonly: "
            + "; ".join(f"{r}: {t['dyn']:.4f} / {t['pallas']:.4f} / {t['weightonly']:.4f} "
                        f"({fastest[r]}; #7 alone {t['pre_q']:.4f}, device dyn "
                        f"{t['dyn device'] or float('nan'):.4f} pallas "
                        f"{t['pallas device'] or float('nan'):.4f})"
                        for r, t in table.items())
            + f"; dyn fastest from {dyn_from} rows on; card: {card}")
        result[label] = {"k": k, "n": n, "ms": table, "fastest": fastest, "dyn_from": dyn_from}
    return result


# The prefill shapes (batch, length) of ``--auto-model-times``: request A's
# batch at 16 to 256 positions, then request B's 64 prompts of 32 and 64.
AUTO_MODEL_SHAPES = ((4, 16), (4, 32), (4, 64), (4, 128), (4, 256), (64, 32), (64, 64))


def auto_model_times(card):
    """``auto``'s threshold at the model level: the prefill of the 1.5B
    int8 dense SSM, MHA and MoE SSM models (the engine's attachments: int8
    head, fused QKV, fat stack) at AUTO_MODEL_SHAPES under ``auto`` with its
    pre-norms fused (#5, their consumers #7: ``AUTO_DYN_ROWS`` set to 1) and
    without (every linear #6: None), and under ``dyn`` beside them. Each the
    CUDA-event mean of 5 calls with the host's enqueue and the profiler's
    device time; the logits finite, #5 launched where the form fuses a
    pre-norm and never where it does not, and the share of rows whose
    greedy token the fused and unfused forms share reported. Prints each model's
    table and the fewest rows from which the fused form is faster, on the
    device and with the host, at every larger count. Returns {model: {rows:
    {form: ms}}, ...}."""
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.models.quantize import quantize_params
    from apertis_llm_torch.ops import quant as quant_mod
    from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize

    dev = torch.device("cuda", 0)
    dims = calculate_model_dimensions("1.5B", 32000)
    configs = (("dense SSM", dense_preset_config(dims)), ("MHA", mha_preset_config(dims)),
               ("MoE SSM", moe_preset_config(
                   calculate_model_dimensions("1.5B", 32000, use_expert_system=True))))
    forms = (("fused", "auto", 1), ("#6", "auto", None), ("dyn", "dyn", None))
    saved = quant_mod.AUTO_DYN_ROWS
    result = {}
    try:
        for label, cfg in configs:
            tree = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                               dtype=torch.bfloat16)
            perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 2))
            qtree = quantize_params(tree)
            del tree
            m = from_jax_params(qtree, cfg, device=dev, dtype=torch.bfloat16)
            del qtree
            m.quantize_tied_head()
            m.attach_qkv()
            if cfg.use_expert_system:
                m.attach_moe_fat()
            gen = torch.Generator(device=dev).manual_seed(SEED + 23)
            table, greedy = {}, {}
            for b, l in AUTO_MODEL_SHAPES:
                ids = torch.randint(0, cfg.vocab_size, (b, l), generator=gen, device=dev)
                mask = torch.ones((b, l), dtype=torch.int32, device=dev)
                last = torch.full((b,), l - 1, device=dev)
                kw = ({} if cfg.attention_type != "standard_mha"
                      else dict(max_length=l + 8, kv_int8=True))
                cache = m.init_cache(b, **kw)
                row = table[b * l] = {}
                for form, mode, threshold in forms:
                    quant_mod.AUTO_DYN_ROWS = threshold
                    m.set_modes(mode, "fatk")

                    def prefill():
                        return m.prefill(cache, ids, mask, logit_positions=last).logits

                    ln_quantize.launches = 0
                    logits = prefill()[:, 0]
                    if not torch.isfinite(logits).all():
                        raise RuntimeError(f"--auto-model-times {label} at {b} x {l}, {form}: "
                                           "logits not finite")
                    # Each model has a fused site: the SSM mixer's in-projections
                    # or the dense FFN's w1.
                    if dev.type == "cuda" and (ln_quantize.launches > 0) != (form != "#6"):
                        raise RuntimeError(f"--auto-model-times {label} at {b} x {l}, {form}: "
                                           f"#5 launched {ln_quantize.launches} times")
                    greedy[form] = logits.argmax(-1)
                    row[form] = cuda_ms(prefill, iters=5, warmup=2)
                    row[form + " device"] = device_ms(prefill, iters=3)
                row["same greedy"] = float((greedy["fused"] == greedy["#6"]).float().mean())
            fused_from = {}
            for key in ("", " device"):
                fused_from[key.strip() or "host"] = next(
                    (r for r in table if all(table[s]["fused" + key] < table[s]["#6" + key]
                                             for s in table if s >= r)), None)
            log(f"  auto model {label}, prefill ms fused / #6 / dyn (device fused / #6 / dyn): "
                + "; ".join(f"{r}: {t['fused']:.3f} / {t['#6']:.3f} / {t['dyn']:.3f} "
                            f"({t['fused device'] or float('nan'):.3f} / "
                            f"{t['#6 device'] or float('nan'):.3f} / "
                            f"{t['dyn device'] or float('nan'):.3f}; greedy same "
                            f"{t['same greedy']:.2f})" for r, t in table.items())
                + f"; fused faster from {fused_from} rows on; card: {card}")
            result[label] = {"ms": table, "fused_from": fused_from}
            del m
            torch.cuda.empty_cache()
    finally:
        quant_mod.AUTO_DYN_ROWS = saved
    return result


# ---- the decode kernels #3, #4 and #10: warm and cold times ------------------

# int4 FFN packs to rotate over for the cold time: 4 x 23.7 MB of the 1.5B
# model's widths, and 4 x 18.9 MB of the 3B MoE model's int4 fat stacks, more
# than the H100's 50 MB L2.
COLD_INT4_LAYERS = 4
# Seeds of the bf16 moe epilogue's 256-row check beyond the smoke's own
# (ROADMAP.md section 3, fault 2).
FAULT2_SEEDS = 16


def dense_preset_config(dims):
    """The 1.5B dense selective-SSM preset (bench.py's) at the widths `dims`
    of ``calculate_model_dimensions("1.5B", 32000)``, dropout 0."""
    from apertis_llm_torch.config import ApertisConfig
    return ApertisConfig(
        vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
        hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_position_embeddings=4096,
        dtype="bfloat16", param_dtype="bfloat16")


def moe_preset_config(dims):
    """The 1.5B selective-SSM MoE preset (8 experts, top-2) at the widths
    `dims` of ``calculate_model_dimensions("1.5B", 32000,
    use_expert_system=True)``, dropout 0."""
    from apertis_llm_torch.config import ApertisConfig
    return ApertisConfig(
        vocab_size=32000, attention_type="selective_ssm", ssm_d_state=16,
        hidden_size=dims["hidden_size"], num_hidden_layers=dims["num_hidden_layers"],
        num_attention_heads=dims["num_attention_heads"],
        intermediate_size=dims["intermediate_size"], use_expert_system=True, num_experts=8,
        experts_per_token=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        max_position_embeddings=4096, dtype="bfloat16", param_dtype="bfloat16")


def rotation_times(card, label, fns):
    """Warm and cold times of one kernel's calls `fns`, one on each layer's
    weights: warm, the first called again and again (its weights stay in
    L2); cold, all in turn, as a decode step reads them. Each as the
    wrapper's time (CUDA events over back-to-back calls, host included), the
    profiler's device time and a CUDA graph's time a call (graph_ms)."""
    def rotate():
        for f in fns:
            f()
    cold_dev = device_ms(rotate, iters=3)
    cold_graph = graph_ms(rotate, calls=2)
    entry = {"ms": cuda_ms(fns[0]), "device_ms": device_ms(fns[0]), "graph_ms": graph_ms(fns[0]),
             "cold_ms": cuda_ms(rotate, iters=5, warmup=1) / len(fns),
             "cold_device_ms": None if cold_dev is None else cold_dev / len(fns),
             "cold_graph_ms": None if cold_graph is None else cold_graph / len(fns),
             "layers": len(fns)}
    log(f"  {label}: {json.dumps(entry)}; card: {card}")
    return entry


def decode_times(card, qmodel, config, model=None):
    """Warm and cold times (rotation_times) of the int8 decode step (#3,
    dense epilogue) and the int8 and int4 decode FFN (#4) at 64 and 4 rows
    on the int8 model's own weights: cold over its 20 layers (105 MB of
    mixer and 946 MB of FFN int8 weights) and over COLD_INT4_LAYERS int4
    packs, each more than the 50 MB L2; with the bf16 model `model`, the
    bf16 decode FFN (#4) and the bf16 step (#3, dense epilogue) over its 20
    layers (1.9 GB and 212 MB) too. It needs nothing
    of the checkout but the wrappers' Python interface, so an earlier commit
    can run it with this script copied in. Returns {label: {ms, device_ms,
    graph_ms, cold_ms, cold_device_ms, cold_graph_ms, layers}}."""
    from apertis_llm_torch.models.quantize import int4_ffn_pack
    from apertis_llm_torch.ops.kernels.ffn_fused import (
        ffn_decode, ffn_decode_int4, ffn_decode_int8)
    from apertis_llm_torch.ops.kernels.ssm_step import ssm_decode_step
    from apertis_llm_torch.ops.quant import quantize_rows

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    d, c, eps, act = (config.hidden_size, config.ssm_d_inner, config.layer_norm_eps,
                      config.hidden_act)
    layers = qmodel.layers
    mixers = [(lay.attn.mixer_weights(), lay.ffn.pre_norm.weights()) for lay in layers]
    ffn8 = [(lay.ffn.w1.w_q, lay.ffn.w1.w_s, lay.ffn.w1.b, lay.ffn.w2.w_q, lay.ffn.w2.w_s,
             lay.ffn.w2.b) for lay in layers]
    ffn4 = []
    for lay in layers[:COLD_INT4_LAYERS]:
        pk = int4_ffn_pack({"w_q": lay.ffn.w1.w_q, "w_s": lay.ffn.w1.w_s, "b": lay.ffn.w1.b},
                           {"w_q": lay.ffn.w2.w_q, "w_s": lay.ffn.w2.w_s, "b": lay.ffn.w2.b})
        ffn4.append((pk["w1"]["w_q4"], pk["w1"]["w_sh"], pk["w1"]["w_s"], lay.ffn.w1.b,
                     pk["w2"]["w_q4"], pk["w2"]["w_sh"], pk["w2"]["w_s"], lay.ffn.w2.b))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    result = {}
    for rows in (64, 4):
        h, conv = randn(rows, d), randn(rows, config.ssm_conv_kernel - 1, c)
        ssm = randn(rows, c, dtype=torch.float32)
        x_q, x_s = quantize_rows(randn(rows, d))
        calls = {
            "ssm_decode_step_int8": [lambda m=m, fn=fn: ssm_decode_step(h, conv, ssm, m, eps, fn)
                                     for m, fn in mixers],
            "ffn_decode_int8": [lambda w=w: ffn_decode_int8(x_q, x_s, *w, act) for w in ffn8],
            "ffn_decode_int4": [lambda w=w: ffn_decode_int4(x_q, x_s, *w, act) for w in ffn4],
        }
        if model is not None:
            x16 = randn(rows, d)
            calls["ffn_decode"] = [
                lambda f=lay.ffn: ffn_decode(x16, f.w1.w, f.w1.b, f.w2.w, f.w2.b, act)
                for lay in model.layers]
            bf16_mixers = [(lay.attn.mixer_weights(), lay.ffn.pre_norm.weights())
                           for lay in model.layers]
            calls["ssm_decode_step"] = [
                lambda m=m, fn=fn: ssm_decode_step(h, conv, ssm, m, eps, fn)
                for m, fn in bf16_mixers]
        for name, fns in calls.items():
            label = f"{name} at {rows} rows"
            result[label] = rotation_times(card, label, fns)
        # Where #3's device time goes: each launch of the step, by kernel.
        for name in ("ssm_decode_step_int8", "ssm_decode_step"):
            if name not in calls:
                continue
            per = device_ms(calls[name][0], by_kernel=True) or {}
            result[f"{name} at {rows} rows"]["by_kernel_ms"] = per
            log(f"  {name} at {rows} rows by kernel (device ms): "
                + ", ".join(f"{n[:60]} {t:.4f}"
                            for n, t in sorted(per.items(), key=lambda x: -x[1]))
                + f"; card: {card}")
    result.update(xparam_load_times(card, config))
    return result


def xparam_load_times(card, config, rows=64):
    """The x_param product of #3 (int8 (C, R + 2C) = 608 x 1368 at the 1.5B
    model's widths) alone at ``rows`` rows, split over 4 blocks as the
    step's plan splits it, through #7's C entry point, which runs the same
    ring and producer: the weight's rows as the tree holds them (R + 2C
    bytes, not a multiple of 16, so the producer's own loads stage them),
    the weight padded to a multiple of 16 bytes and staged by the same loads,
    and the padded weight loaded by TMA. Device ms each; what padding
    x_param's rows at load time would give."""
    from apertis_llm_torch.ops.kernels import _build
    from apertis_llm_torch.ops.quant import quantize_rows

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    k, n = config.ssm_d_inner, config.ssm_dt_rank + 2 * config.ssm_d_inner
    padded = -(-n // 16) * 16
    lib = _build.load_library()
    x_q, x_s = quantize_rows(torch.randn((rows, k), generator=gen, device=dev))
    w = torch.randint(-127, 128, (k, padded), generator=gen, device=dev, dtype=torch.int8)
    w_s = torch.rand((1, padded), generator=gen, device=dev) * 0.01
    w_tree = w[:, :n].contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {}
    for label, wq, cols, tma_w in ((f"rows of {n} bytes, own loads", w_tree, n, 0),
                                   (f"rows of {padded} bytes, own loads", w, padded, 0),
                                   (f"rows of {padded} bytes, TMA", w, padded, 1)):
        out = torch.empty((rows, cols), dtype=torch.bfloat16, device=dev)
        call = lambda wq=wq, cols=cols, tma_w=tma_w, out=out: _build.check(  # noqa: E731
            lib.apertis_quant_matmul_dyn(x_q.data_ptr(), x_s.data_ptr(), wq.data_ptr(),
                                         w_s.data_ptr(), None, out.data_ptr(), rows, cols, k, 1,
                                         64, 4, 1, tma_w, stream), "x_param product")
        result[label] = device_ms(call)
    log(f"  #3's x_param product alone ({rows} x {k} x {n}, split 4, device ms): "
        + ", ".join(f"{lab} {t:.4f}" for lab, t in result.items()) + f"; card: {card}")
    return {f"x_param product at {rows} rows": result}


def moe_step_times(card, moe_qmodel, moe_config, moe_model=None):
    """rotation_times of the int8 decode step with the moe epilogue (#3) at
    64 and 4 rows over the int8 MoE model's 44 layers (D 704, C 176), and
    with the bf16 MoE model `moe_model` the bf16 step's over its 44 layers.
    Like decode_times, an earlier commit can run it with this script copied
    in."""
    from apertis_llm_torch.ops.kernels.ssm_step import ssm_decode_step

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    d, c, eps = moe_config.hidden_size, moe_config.ssm_d_inner, moe_config.layer_norm_eps
    models = [("ssm_decode_step_int8_moe", moe_qmodel)]
    if moe_model is not None:
        models.append(("ssm_decode_step_moe", moe_model))
    result = {}
    for rows in (64, 4):
        h = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        conv = torch.randn((rows, moe_config.ssm_conv_kernel - 1, c), generator=gen,
                           device=dev).to(torch.bfloat16)
        ssm = torch.randn((rows, c), generator=gen, device=dev)
        for name, m_ in models:
            steps = [(lay.attn.mixer_weights(), lay.ffn.pre_norm.weights(),
                      lay.ffn.router_weights()) for lay in m_.layers]
            fns = [lambda m=m, fn=fn, r=r: ssm_decode_step(h, conv, ssm, m, eps, fn, None, r)
                   for m, fn, r in steps]
            label = f"{name} at {rows} rows"
            result[label] = rotation_times(card, label, fns)
    return result


def fat_times(card, moe_model, moe_config, layers=None):
    """rotation_times of the fat MoE FFN (#10) at 64 and 4 rows over the
    MoE model's attached fat stacks (int8, or int4 where they are packed),
    all its layers or the first `layers`: each call on pre-normed random
    rows with the combine weights of its layer's own router (two nonzero a
    row), as serving calls it, so that the skip of the experts no row routes
    to is timed as serving meets it. Like decode_times, an earlier commit
    can run it with this script copied in."""
    from apertis_llm_torch.ops import moe as moe_ops
    from apertis_llm_torch.ops.kernels.moe_ffn import expert_ffn_fat, expert_ffn_fat_int4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    d, n_exp, eps = moe_config.hidden_size, moe_config.num_experts, moe_config.layer_norm_eps
    act = moe_config.hidden_act
    lays = moe_model.layers[:layers]
    int4 = "w1t_q4" in lays[0].ffn.experts.fat()
    name = "expert_ffn_fat_int4" if int4 else "expert_ffn_fat"
    result = {}
    for rows in (64, 4):
        fns, routed = [], []
        for lay in lays:
            ffn, fat = lay.ffn, lay.ffn.experts.fat()
            x = ffn.pre_norm(torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16))
            routing = moe_ops.route(x, *ffn.router_weights(), 2, layer_norm_eps=eps)
            xq, xs = moe_ops.center_quantize(x, eps)
            comb = moe_ops._combine_weights(routing, n_exp, torch.float32)
            routed.append(int((comb != 0).any(dim=0).sum()))
            if int4:
                args = (xq, xs, comb, fat["w1t_q4"], fat["w1t_sh"], fat["w1t_s"], fat["b1t"],
                        fat["w2t_q4"], fat["w2t_sh"], fat["w2t_s"], n_exp, act)
                fns.append(lambda a=args: expert_ffn_fat_int4(*a))
            else:
                args = (xq, xs, comb, fat["w1t_q"], fat["w1t_s"], fat["b1t"], fat["w2t_q"],
                        fat["w2t_s"], n_exp, act)
                fns.append(lambda a=args: expert_ffn_fat(*a))
        label = f"{name} at {rows} rows"
        result[label] = rotation_times(card, label, fns)
        result[label]["experts_routed_mean"] = sum(routed) / len(routed)
    return result


def dense_times(card, moe_model, moe_config):
    """rotation_times of the per-expert MoE FFN (#11, ``moe_mode="kernel"``)
    at 64 and 4 rows over the int8 MoE model's per-expert stacks: warm on
    the first layer's, cold over all 44 (31.7 MB of int8 expert weights
    each), each call on pre-normed random rows centred and quantized as
    moe_dense_fused gives them. Like decode_times, an earlier commit can run
    it with this script copied in."""
    from apertis_llm_torch.ops import moe as moe_ops
    from apertis_llm_torch.ops.kernels.moe_ffn import expert_ffn_dense

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    d, eps, act = moe_config.hidden_size, moe_config.layer_norm_eps, moe_config.hidden_act
    result = {}
    for rows in (64, 4):
        fns = []
        for lay in moe_model.layers:
            ffn, st = lay.ffn, lay.ffn.experts.fused()
            x = ffn.pre_norm(torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16))
            xq, xs = moe_ops.center_quantize(x, eps)
            args = (xq, xs, st["w1f_q"], st["w1f_s"], st["b1f"], st["w2f_q"], st["w2f_s"],
                    ffn.experts.b2.float(), torch.bfloat16, act)
            fns.append(lambda a=args: expert_ffn_dense(*a))
        label = f"expert_ffn_dense at {rows} rows"
        result[label] = rotation_times(card, label, fns)
    return result


def scan_fwd_times(card):
    """The scan forwards' times on seeded operands as the main path gives
    them. #1 (selective_scan_fwd, bf16 B and C, bf16 y): the prefill of
    request B (64, 32, 38, 16) with the all-ones mask that generate and
    prefill pass, and without a mask, and of request A (4, 64, 38, 16,
    masked at 7/19/32/45), the dense and MoE-mixer training forwards (4, 1024, 38 and
    11, 16) with every state; #2 (selective_scan_carry_fwd, from an h_init):
    a rank's share of the 1.5B training sequence under seq = 2 (4, 38, 512,
    16) and the whole sequence in f32, and the rank's share with b in bf16
    and its f32 states. For each: the wrapper's CUDA-event time, the
    profiler's device time, in all and by kernel, and the bound of the
    bytes the forward must move, each output held to its tolerance against
    the plain version; where the checkout has the chunked launches, the
    device time at other chunks too, each chunk held to the tolerances. An
    earlier commit can run it with this script copied in."""
    from apertis_llm_torch.ops.kernels import ssm_scan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    bf16, f32 = torch.bfloat16, torch.float32
    chunks = (8, 16, 32, 64, 128)
    result = {}

    def timed(label, kernel, plain, args, tols, moved, ops, sweep):
        res = {"ms": cuda_ms(lambda: kernel(*args)), "device_ms": device_ms(lambda: kernel(*args)),
               "device_ms_by_kernel": device_ms(lambda: kernel(*args), by_kernel=True),
               "bound_ms": bound(moved, ops, "f32")[0]}
        ref = plain(*args)
        for (out_name, tol), got, want in zip(tols, kernel(*args), ref):
            compare(f"{label} {out_name}", got, want, tol)
        if sweep is not None:
            res["device_ms_by_chunk"] = {}
            for chunk in chunks:
                for (out_name, tol), got, want in zip(tols, sweep(*args, chunk), ref):
                    compare(f"{label} at chunks of {chunk}, {out_name}", got, want, tol)
                res["device_ms_by_chunk"][chunk] = device_ms(lambda c=chunk: sweep(*args, c))
        result[label] = res
        log(f"  {label}: {json.dumps(res)}; card: {card}")

    for (b, l, h, n), lens, want_h, what in (
            ((64, 32, 38, 16), [32] * 64, False, "prefill of request B, all-ones mask"),
            ((64, 32, 38, 16), None, False, "prefill of request B"),
            ((4, 64, 38, 16), [7, 19, 32, 45], False, "prefill of request A, masked"),
            ((4, 1024, 38, 16), None, True, "dense training, every state"),
            ((4, 1024, 11, 16), None, True, "MoE mixer training, every state")):
        delta = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=gen, device=dev) - 4.0)
        a_cont = -torch.empty((h, n), device=dev).uniform_(0.5, 0.99, generator=gen)
        bt, ct = (torch.randn((b, l, h, n), generator=gen, device=dev).to(bf16)
                  for _ in range(2))
        mask = None
        if lens is not None:
            mask = (torch.arange(l, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        args = (delta, a_cont, bt, ct, mask, bf16, want_h)
        moved = (nbytes(delta, a_cont, bt, ct, mask) + nbytes(bt) + 4 * b * h * n
                 + (4 * bt.numel() if want_h else 0))
        tols = [("y", BF16_ULP), ("h_last", SCAN_F32_TOL), ("hs", SCAN_F32_TOL)]
        sweep = getattr(ssm_scan, "_scan_fwd_launch", None)
        timed(f"selective_scan_fwd {(b, l, h, n)} ({what})", ssm_scan.selective_scan_fwd,
              ssm_scan.selective_scan_fwd_reference, args, tols, moved, 6 * bt.numel(), sweep)
    for (b, h, l, n), dtype, want_states in (((4, 38, 512, 16), f32, False),
                                             ((4, 38, 1024, 16), f32, False),
                                             ((4, 38, 512, 16), bf16, True)):
        a = torch.empty((b, h, l, n), device=dev).uniform_(0.4, 0.999, generator=gen)
        bt = torch.randn((b, h, l, n), generator=gen, device=dev).to(dtype)
        h0 = torch.randn((b, h, n), generator=gen, device=dev)
        args = (a, bt, h0, want_states)
        extra = nbytes(a) if want_states and dtype == bf16 else 0
        moved = nbytes(a, bt, h0) + nbytes(bt) + nbytes(bt[:, :, 0]) + extra
        tol = CARRY_TOL if dtype == f32 else BF16_ULP
        tols = [("h", tol), ("h_last", tol), ("states", CARRY_TOL)]
        sweep = getattr(ssm_scan, "_carry_fwd_launch", None)
        label = (f"selective_scan_carry_fwd {(b, h, l, n)} from h_init, b {str(dtype)[6:]}"
                 f"{', with its f32 states' if want_states else ''}")
        timed(label, ssm_scan.selective_scan_carry_fwd,
              ssm_scan.selective_scan_carry_fwd_reference, args, tols, moved, 2 * a.numel(),
              sweep)
    return result


def scan_bwd_times(card):
    """The scan backward's times (#1: selective_scan_bwd at the 1.5B
    training shape (4, 1024, 38, 16), selective_scan_bwd_smem at N = 12 and
    the MoE mixer's 11 heads of 16) on seeded operands as training gives
    them: the wrapper's CUDA-event time, the profiler's device time by
    kernel, and the bound of the bytes the gradient must move. It needs
    nothing of the checkout but the wrappers' Python interface, so an
    earlier commit can run it with this script copied in."""
    from apertis_llm_torch.ops.kernels.ssm_scan import (
        selective_scan_bwd, selective_scan_bwd_smem, selective_scan_fwd)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    result = {}
    for fn, (b, l, h, n) in ((selective_scan_bwd, (4, 1024, 38, 16)),
                             (selective_scan_bwd_smem, (4, 1024, 38, 12)),
                             (selective_scan_bwd, (4, 1024, 11, 16))):
        delta = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=gen, device=dev) - 4.0)
        a_cont = -torch.empty((h, n), device=dev).uniform_(0.5, 0.99, generator=gen)
        bt, ct, gy = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for shape in ((b, l, h, n), (b, l, h, n), (b, l, h * n)))
        hs = selective_scan_fwd(delta, a_cont, bt, ct, None, torch.bfloat16, want_h=True)[2]
        args = (delta, a_cont, ct, None, hs, gy, None)
        moved = nbytes(delta, a_cont, ct, hs, gy) + nbytes(delta, a_cont) + 2 * nbytes(ct)
        label = f"{fn.__name__} {(b, l, h, n)}"
        result[label] = {"ms": cuda_ms(lambda: fn(*args)),
                         "device_ms": device_ms(lambda: fn(*args)),
                         "device_ms_by_kernel": device_ms(lambda: fn(*args), by_kernel=True),
                         "bound_ms": bound(moved, 12 * ct.numel(), "f32")[0]}
        log(f"  {label}: {json.dumps(result[label])}; card: {card}")
    # #2's backward (selective_scan_carry_bwd) from an h_init, with g_last,
    # at a rank's share of the 1.5B training sequence under seq = 2 (the
    # mesh run's shape) and at the whole sequence; where the checkout has
    # the chunked launch, its device time at other chunks too.
    from apertis_llm_torch.ops.kernels import ssm_scan
    for b, h, l, n in ((4, 38, 512, 16), (4, 38, 1024, 16)):
        a = torch.empty((b, h, l, n), device=dev).uniform_(0.4, 0.999, generator=gen)
        bt, g, h0, g_last = (torch.randn(shape, generator=gen, device=dev)
                             for shape in ((b, h, l, n), (b, h, l, n), (b, h, n), (b, h, n)))
        states = ssm_scan.selective_scan_carry_fwd(a, bt, h0, want_states=True)[2]
        args = (a, g, states, h0, g_last)
        moved = nbytes(*args) + 2 * nbytes(a) + nbytes(h0)
        label = f"selective_scan_carry_bwd {(b, h, l, n)} from h_init"
        res = {"ms": cuda_ms(lambda: ssm_scan.selective_scan_carry_bwd(*args)),
               "device_ms": device_ms(lambda: ssm_scan.selective_scan_carry_bwd(*args)),
               "device_ms_by_kernel": device_ms(
                   lambda: ssm_scan.selective_scan_carry_bwd(*args), by_kernel=True),
               "bound_ms": bound(moved, 3 * a.numel(), "f32")[0]}
        ref = ssm_scan.selective_scan_carry_bwd_reference(*args)
        for out_name, got, want in zip(("da", "db", "dh_init"),
                                       ssm_scan.selective_scan_carry_bwd(*args), ref):
            compare(f"{label} {out_name}", got, want, CARRY_BWD_TOL)
        if hasattr(ssm_scan, "_carry_bwd_launch"):
            res["device_ms_by_chunk"] = {}
            for chunk in (8, 16, 32, 64, 128):
                got = ssm_scan._carry_bwd_launch(*args, chunk)
                compare(f"{label} at chunks of {chunk}, db", got[1], ref[1], CARRY_BWD_TOL)
                res["device_ms_by_chunk"][chunk] = device_ms(
                    lambda c=chunk: ssm_scan._carry_bwd_launch(*args, c))
        result[label] = res
        log(f"  {label}: {json.dumps(res)}; card: {card}")
    return result


def grouped_times(card):
    """The grouped MoE FFN's times (#12) at request B's 2048 tokens and the
    ragged 37, at the 1.5B MoE preset's widths (H 704, 8 experts of 2816)
    on one layer's int8 fat stack made from seeded f32 experts, each token
    routed to two experts with phase 3b's uneven loads (expert 7 empty): the
    wrapper's CUDA-event time, the profiler's device time, in all and by
    kernel, and the bound of the bytes and the live rows' int8 operations;
    where the checkout has ``decode_plan.grouped_plan``, the device time at
    row tiles of 64 and 128 too. An earlier commit can run it with this
    script copied in."""
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.moe_fuse import fuse_one_fat
    from apertis_llm_torch.ops import moe as moe_ops
    from apertis_llm_torch.ops.kernels import decode_plan, moe_grouped

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    cfg = moe_preset_config(calculate_model_dimensions("1.5B", 32000, use_expert_system=True))
    h, inter, n_exp = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    fat = fuse_one_fat({"ln_w": 1 + randn(n_exp, h, std=0.1), "ln_b": randn(n_exp, h, std=0.1),
                        "w1": randn(n_exp, h, inter, std=0.02),
                        "b1": randn(n_exp, inter, std=0.1),
                        "w2": randn(n_exp, inter, h, std=0.02)})
    probs = torch.tensor([8.0, 4, 2, 1, 1, 1, 1, 0], device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for s_ in (2048, 37):
        idx = torch.multinomial(probs.expand(s_, n_exp), 2, replacement=False, generator=gen)
        xq, xs = moe_ops.center_quantize(randn(s_, h).to(torch.bfloat16), cfg.layer_norm_eps)
        dest, emap = moe_ops.grouped_dispatch(idx, n_exp)
        p = emap.numel() * moe_grouped.TILE
        xq_pad = torch.zeros((p, h), dtype=torch.int8, device=dev)
        xs_pad = torch.zeros((p, 1), dtype=torch.float32, device=dev)
        xq_pad[dest] = xq.repeat_interleave(2, dim=0)
        xs_pad[dest] = xs.repeat_interleave(2, dim=0)
        args = (xq_pad, xs_pad, emap, fat["w1t_q"], fat["w1t_s"], fat["b1t"], fat["w2t_q"],
                fat["w2t_s"], n_exp, cfg.hidden_act)
        used = int(torch.unique(emap[emap >= 0]).numel())
        moved = (nbytes(xq_pad, xs_pad, emap, fat["w2t_s"]) + xq_pad.numel() * 2
                 + sum(nbytes(fat[k]) for k in ("w1t_q", "w1t_s", "b1t", "w2t_q")) * used // n_exp)
        label = f"expert_ffn_grouped {s_} tokens: P = {p}, {int((emap >= 0).sum())} live tiles"
        res = {"ms": cuda_ms(lambda: moe_grouped.expert_ffn_grouped(*args)),
               "device_ms": device_ms(lambda: moe_grouped.expert_ffn_grouped(*args)),
               "device_ms_by_kernel": device_ms(
                   lambda: moe_grouped.expert_ffn_grouped(*args), by_kernel=True),
               "bound_ms": bound(moved, 4 * 2 * s_ * h * inter, "int8")[0]}
        got = moe_grouped.expert_ffn_grouped(*args)
        compare(f"{label} out", got, moe_grouped.expert_ffn_grouped_reference(*args), BF16_ULP)
        if hasattr(decode_plan, "grouped_plan"):
            for br in (64, 128):
                plan = decode_plan._expert_plan(p, br, h, inter, 1, sms)
                if not torch.equal(moe_grouped._grouped_launch(*args, plan), got):
                    raise RuntimeError(f"{label}: row tile {br} gives other bits")
                res[f"row_tile_{br}"] = {"plan": plan, "device_ms_by_kernel": device_ms(
                    lambda pl=plan: moe_grouped._grouped_launch(*args, pl), by_kernel=True)}
        result[label] = res
        log(f"  {label}: {json.dumps(res)}; card: {card}")
    return result


# The fused norm + quantize (#5) at the main path's shapes: (label, rows, H,
# LayerNorm, eps). Request B's prefill rows at the 1.5B dense width with
# either norm, request A's 4 x 64 rows, the MoE mixer's D = 704 at request
# B's rows, the int8 ViT's ln1 / ln2 over request B's 64 images of 197
# tokens (LayerNorm with bias, eps 1e-5) and a ragged 37 rows.
LN_SHAPES = (("request B's prefill, LayerNorm", 2048, 2432, True, 1e-12),
             ("request B's prefill, RMSNorm", 2048, 2432, False, 1e-12),
             ("request A's prefill (4 x 64), LayerNorm", 256, 2432, True, 1e-12),
             ("the MoE mixer's D = 704, LayerNorm", 2048, 704, True, 1e-12),
             ("the int8 ViT's 64 x 197 tokens, LayerNorm, eps 1e-5", 12608, 768, True, 1e-5),
             ("ragged rows, LayerNorm", 37, 2432, True, 1e-12))


def ln_operands(rows, h, layer_norm, gen, dev):
    """Seeded bf16 operands of ``ln_quantize``: x of std 2, a norm weight of
    1 + 0.1 noise and (LayerNorm) a bias of 0.1 noise."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std
    w = (1 + randn(h, std=0.1)).to(torch.bfloat16)
    b = randn(h, std=0.1).to(torch.bfloat16) if layer_norm else None
    return randn(rows, h, std=2.0).to(torch.bfloat16), w, b


def ln_cost(x, w, b):
    """(bytes, operations, type) of ``ln_quantize`` on x: x, w and b read
    once, q and the scales written once; about 10 f32 operations an
    element."""
    rows = x.numel() // x.shape[-1]
    return nbytes(x, w, b) + x.numel() + rows * 4, 10 * x.numel(), "f32"


def ln_times(card):
    """The fused norm + quantize's times (#5, ``ln_quantize``) at LN_SHAPES
    on seeded operands: the wrapper's CUDA-event time, the profiler's device
    time and the bound of the bytes it must move, each output held to its
    tolerance against the plain version (levels one apart on under
    INT8_FLIP_SHARE of the elements, scales within SCALE_TOL); where the
    checkout has ``ln_quant.ln_plan``, the plan, its resources and the
    device time at other threads a row, each held to the same tolerances.
    An earlier commit can run it with this script copied in."""
    from apertis_llm_torch.ops.kernels import ln_quant

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    result = {}
    for label, rows, h, layer_norm, eps in LN_SHAPES:
        x, w, b = ln_operands(rows, h, layer_norm, gen, dev)
        args = (x, w, b, eps)
        label = f"ln_quantize {rows} x {h} ({label})"
        res = {"ms": cuda_ms(lambda: ln_quant.ln_quantize(*args)),
               "device_ms": device_ms(lambda: ln_quant.ln_quantize(*args)),
               "bound_ms": bound(*ln_cost(x, w, b))[0]}
        ref = ln_quant.ln_quantize_reference(*args)
        got = ln_quant.ln_quantize(*args)
        compare_int8(f"{label} x_q", got[0], ref[0])
        compare(f"{label} x_s", got[1], ref[1], SCALE_TOL)
        res["bit_equal"] = all(torch.equal(a, r) for a, r in zip(got, ref))
        if hasattr(ln_quant, "ln_plan"):
            plan = ln_quant.ln_plan(h, rows)
            res["plan"] = plan._asdict()
            res["resources"] = ln_quant.ln_quantize_resources(plan)
            res["device_ms_by_threads"] = {}
            for threads in (8, 16, 32, 64, 128, 256):
                try:
                    plan = ln_quant.ln_plan(h, threads=threads)
                except ValueError:
                    continue
                got = ln_quant._ln_launch(*args, threads)
                compare_int8(f"{label} at {threads} threads a row, x_q", got[0], ref[0])
                compare(f"{label} at {threads} threads a row, x_s", got[1], ref[1], SCALE_TOL)
                res["device_ms_by_threads"][threads] = {
                    "nv": plan.nv, "bit_equal": all(torch.equal(a, r) for a, r in zip(got, ref)),
                    "device_ms": device_ms(lambda t=threads: ln_quant._ln_launch(*args, t)),
                    **ln_quant.ln_quantize_resources(plan)}
        result[label] = res
        log(f"  {label}: {json.dumps(res)}; card: {card}")
    return result


def parallel_rank(rank, scan_args, small, preset):
    """One of phase 7's two ranks, which share the card in a gloo process
    group (``apertis_llm_torch.parallel.spawn``): the sequence-parallel scan
    on its half of L, a 2-layer f32 dense-SSM train step on meshes
    (1, 1, 1, 2) and (2, 1, 1, 1) and two updates after it, then the 1.5B
    dense preset trained on (1, 1, 1, 2). Returns what the parent compares
    and reports."""
    import hashlib

    from apertis_llm_torch.config import ApertisConfig
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.ops.kernels.ssm_scan import (
        selective_scan_bwd, selective_scan_carry_bwd, selective_scan_carry_fwd,
        selective_scan_fwd)
    from apertis_llm_torch.parallel import create_mesh, parallel_context
    from apertis_llm_torch.parallel.collectives import all_reduce_sum
    from apertis_llm_torch.parallel.sequence import ssm_scan_sequence_parallel
    from apertis_llm_torch.training import step as step_module
    from apertis_llm_torch.training.trainer import ApertisTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}

    a, b, w = (torch.as_tensor(x, device=dev) for x in scan_args)
    half = a.shape[2] // 2
    cols = slice(rank * half, (rank + 1) * half)
    at = a[:, :, cols].contiguous().requires_grad_()
    bt = b[:, :, cols].contiguous().requires_grad_()
    h, h_last = ssm_scan_sequence_parallel(at, bt, create_mesh((1, 1, 1, 2)))
    da, db = torch.autograd.grad((h ** 2).sum() + (h_last * w).sum(), (at, bt))
    out["scan"] = [t.detach().cpu() for t in (h, h_last, da, db)]

    cfg_kw, tree, ids = small
    out["small"] = {}
    for shape in ((1, 1, 1, 2), (2, 1, 1, 1)):
        mesh = create_mesh(shape)
        model = from_jax_params(tree, ApertisConfig(**cfg_kw), device=dev)
        part = step_module.shard_batch({"input_ids": ids, "labels": ids}, mesh)
        part = {k: v if isinstance(v, int) else torch.as_tensor(v, device=dev)
                for k, v in part.items()}
        params = dict(model.named_parameters())
        with parallel_context(mesh):
            loss, _ = step_module.loss_fn(model, part, None)
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = {name: g_.contiguous() for name, g_ in zip(params, grads)}
        step_module.reduce_gradients(grads)
        total = loss.detach().clone()
        all_reduce_sum([total])
        optimizer, _ = step_module.make_optimizer(params, step_module.decay_mask(model), 1e-3, 10)
        for i in range(2):
            step_module.train_step(model, optimizer, part, i, None, mesh)
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        out["small"][shape] = (float(total), {k: v.cpu() for k, v in grads.items()},
                               digest.hexdigest())

    cfg, seqs, micro, trainer_kw = preset
    rows, length = seqs.shape
    dataset = TokenRows([{"input_ids": seqs[i % rows], "labels": seqs[i % rows]}
                         for i in range(micro * rows)], length)
    tree = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    trainer = ApertisTrainer(cfg, tree, dataset, device=dev, mesh_shape=(1, 1, 1, 2),
                             **trainer_kw)
    del tree
    reduce_ms = []
    real_reduce = step_module.reduce_gradients

    def timed_reduce(grads_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(grads_)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    step_module.reduce_gradients = timed_reduce
    counters = (selective_scan_carry_fwd, selective_scan_carry_bwd, selective_scan_fwd,
                selective_scan_bwd)
    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    out["preset"] = dict(
        losses=history["step_losses"], final_step=history["final_step"],
        p50_s=history["perf"]["step_time_p50_s"], wall_s=time.perf_counter() - t0,
        reduce_ms=reduce_ms, launches={f.__name__: f.launches for f in counters},
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        grad_bytes=sum(p.numel() * 4 for p in trainer.model.parameters()))
    return out


def f32_forms_phase(checks, dev):
    """Phase 3i: the f32 forms of the decode kernels against their plain
    versions at the 1.5B dense widths (hidden 2432, 38 heads, d_state 16,
    FFN 9728), on one f32 layer and its int8 quantization (f32 norms,
    biases and rows): #3 (``ssm_decode_step_f32``, epilogues none, dense
    and moe, both norms; ``ssm_decode_step_int8_f32``), #4
    (``ffn_decode_f32`` on the step's bf16 FFN input and on f32 rows;
    ``ffn_decode_int8_f32``) at 64, 4 and 1 rows, #9 (``mha_decode_ctx_f32``
    and ``_int8_f32``) at (64, 96) and (1, 88) slots with heads of 64 and
    128, and #5 (``ln_quantize_f32``) at the eval's and the prefill's rows;
    sensitivity checks that drop each term, each timed shape run twice for
    the same bits. Returns #9 f32's SDPA f32 time (the library yardstick)."""
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.models.quantize import quantize_params
    from apertis_llm_torch.ops.kernels.ffn_fused import (
        ffn_decode_f32, ffn_decode_int8_f32, ffn_decode_int8_reference, ffn_decode_reference)
    from apertis_llm_torch.ops.kernels.ln_quant import ln_quantize_f32, ln_quantize_reference
    from apertis_llm_torch.ops.kernels.mha_step import (
        NEG, mha_decode_ctx_f32, mha_decode_ctx_int8_f32, mha_decode_ctx_reference,
        quantize_heads)
    from apertis_llm_torch.ops.kernels.ssm_step import (
        RouterWeights, ssm_decode_step_f32, ssm_decode_step_int8_f32,
        ssm_decode_step_reference)
    from apertis_llm_torch.ops.quant import quantize_rows

    card = checks.card
    f32 = torch.float32
    dims = calculate_model_dimensions("1.5B", 32000)
    config = dense_preset_config(dims)
    config.num_hidden_layers, config.dtype, config.param_dtype = 1, "float32", "float32"
    tree = init_params(config, torch.Generator(device=dev).manual_seed(SEED + 22), device=dev)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 23))
    model = from_jax_params(tree, config, device=dev)
    qmodel = from_jax_params(quantize_params(tree), config, device=dev)
    del tree
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    d, c, inter, eps = config.hidden_size, config.ssm_d_inner, config.intermediate_size, \
        config.layer_norm_eps

    def randn(*shape, dtype=f32, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    layer, qlayer = model.layers[0], qmodel.layers[0]
    mixer, qmixer = layer.attn.mixer_weights(), qlayer.attn.mixer_weights()
    fnorm = layer.ffn.pre_norm.weights()
    n_exp = 8
    router = RouterWeights(1 + randn(d, std=0.1), randn(d, std=0.1), randn(d, n_exp, std=0.05),
                           randn(n_exp, std=0.1))
    log(f"f32 forms (SIMT, f32 sums): one f32 layer at the 1.5B widths (hidden {d}, mixer "
        f"{c}, FFN {inter}) and its int8 quantization with f32 norms, biases and rows")

    def step_inputs(b, w, fn=fnorm, rt=None):
        return (randn(b, d), randn(b, config.ssm_conv_kernel - 1, c), randn(b, c), w, eps, fn,
                None, rt)

    def step_cost(args):
        h, conv, ssm, w, _, fn, _, rt = args
        rows, r_ = h.shape[0], w.dt_w.shape[0]
        weights = [getattr(w, f) for f in w._fields if isinstance(getattr(w, f), torch.Tensor)]
        macs = d * c * 2 + c * (r_ + 2 * c) + c * d + (d * n_exp if rt is not None else 0)
        outs = nbytes(h, ssm) + rows * c * conv.element_size()
        if rt is not None:
            outs += rows * (d + 4 + 4 * n_exp)
        elif fn is not None:
            outs += rows * d * (1 if w.quantized else 2) + (4 * rows if w.quantized else 0)
        return (nbytes(h, conv, ssm, *weights, *(fn or ()), *(rt or ())) + outs,
                2 * rows * macs, "int8" if w.quantized else "f32")

    tol = F32_FORM_TOL
    step_tols = [("h_out", tol), ("x_proj", tol), ("ssm", tol), ("ffn_in", BF16_ULP)]
    step_tols_q = [("h_out", BF16_ULP), ("x_proj", BF16_ULP), ("ssm", BF16_ULP),
                   ("x_q", "int8"), ("x_s", BF16_ULP)]
    moe_tols = step_tols[:3] + [("x_q", "int8"), ("x_s", BF16_ULP), ("comb", F32_TOL)]
    args = step_inputs(5, mixer)

    def without(**terms):
        return args[:3] + (mixer._replace(**terms),) + args[4:]

    checks.sensitive("f32 decode step", ssm_decode_step_reference, args, {
        "pre-norm weight": without(norm_w=torch.ones_like(mixer.norm_w)),
        "pre-norm bias": without(norm_b=torch.zeros_like(mixer.norm_b)),
        "conv bias": without(conv_b=torch.zeros_like(mixer.conv_b)),
        "dt bias": without(dt_b=torch.zeros_like(mixer.dt_b)),
        "D * x skip": without(d_skip=torch.zeros_like(mixer.d_skip)),
        "FFN pre-norm weight": args[:5] + ((torch.ones_like(fnorm[0]), fnorm[1]),) + args[6:],
        "FFN pre-norm bias": args[:5] + ((fnorm[0], torch.zeros_like(fnorm[1])),) + args[6:],
    }, step_tols)
    qargs = step_inputs(5, qmixer)
    checks.sensitive("int8 f32 decode step", ssm_decode_step_reference, qargs, {
        f"{name} w_s": qargs[:3] + (qmixer._replace(**{name: torch.ones_like(
            getattr(qmixer, name))}),) + qargs[4:]
        for name in ("inx_s", "inz_s", "xparam_s", "out_s")}, step_tols_q)
    margs = step_inputs(5, mixer, rt=router)
    checks.sensitive("f32 decode step, moe epilogue", ssm_decode_step_reference, margs, {
        "router bias": margs[:7] + (router._replace(b=torch.zeros_like(router.b)),),
        "router LayerNorm bias": margs[:7] + (router._replace(ln_b=torch.zeros_like(router.ln_b)),),
    }, moe_tols)
    for b in (64, 4, 1):
        for w, fn, label in [(mixer, fnorm, "LayerNorm, dense"),
                             (mixer, None, "LayerNorm, ffn_mode none"),
                             (mixer._replace(norm_b=None), (fnorm[0], None), "RMSNorm, dense")]:
            a = step_inputs(b, w, fn)
            checks.kernel("ssm_decode_step_f32", f"f32 decode step B={b} {label}", a,
                          ssm_decode_step_f32, ssm_decode_step_reference,
                          step_tols if fn is not None else step_tols[:3],
                          cost=step_cost(a) if label == "LayerNorm, dense" else None,
                          repeat=b == 64, shape=None if b == 64 else f"{b} rows")
        a = step_inputs(b, mixer, rt=router)
        checks.kernel("ssm_decode_step_f32", f"f32 decode step B={b} moe epilogue", a,
                      ssm_decode_step_f32, ssm_decode_step_reference, moe_tols, repeat=b == 64)
        for w, fn, label in [(qmixer, fnorm, "LayerNorm, dense"),
                             (qmixer, None, "LayerNorm, ffn_mode none"),
                             (qmixer._replace(norm_b=None), (fnorm[0], None), "RMSNorm, dense")]:
            a = step_inputs(b, w, fn)
            checks.kernel("ssm_decode_step_int8_f32", f"int8 f32 decode step B={b} {label}", a,
                          ssm_decode_step_int8_f32, ssm_decode_step_reference,
                          step_tols_q if fn is not None else step_tols_q[:3],
                          cost=step_cost(a) if label == "LayerNorm, dense" else None,
                          repeat=b == 64, shape=None if b == 64 else f"{b} rows")

    w1, w2 = layer.ffn.w1, layer.ffn.w2
    q1, q2 = qlayer.ffn.w1, qlayer.ffn.w2

    def ffn_args(s_, act=config.hidden_act, x_dtype=torch.bfloat16):
        return (randn(s_, d, dtype=x_dtype), w1.w, w1.b, w2.w, w2.b, act, f32)

    def ffn_q_args(s_, act=config.hidden_act):
        x_q, x_s = quantize_rows(randn(s_, d))
        return (x_q, x_s, q1.w_q, q1.w_s, q1.b, q2.w_q, q2.w_s, q2.b, act, f32)

    a = ffn_args(5)
    checks.sensitive("f32 ffn", ffn_decode_reference, a, {
        "b1": a[:2] + (torch.zeros_like(w1.b),) + a[3:],
        "b2": a[:4] + (torch.zeros_like(w2.b),) + a[5:]}, [("out", tol)])
    a = ffn_q_args(5)
    checks.sensitive("int8 f32 ffn", ffn_decode_int8_reference, a, {
        "b1": a[:4] + (torch.zeros_like(q1.b),) + a[5:],
        "b2": a[:7] + (torch.zeros_like(q2.b),) + a[8:]}, [("out", BF16_ULP)])
    ffn_bytes = nbytes(w1.w, w1.b, w2.w, w2.b)
    q_bytes = nbytes(q1.w_q, q1.w_s, q1.b, q2.w_q, q2.w_s, q2.b)
    for s_ in (64, 4, 1):
        a = ffn_args(s_)
        checks.kernel("ffn_decode_f32", f"f32 ffn S={s_}", a, ffn_decode_f32,
                      ffn_decode_reference, [("out", tol)],
                      cost=(ffn_bytes + nbytes(a[0]) + 4 * s_ * d, 4 * s_ * d * inter, "f32"),
                      repeat=s_ == 64, shape=None if s_ == 64 else f"{s_} rows")
        a = ffn_q_args(s_)
        checks.kernel("ffn_decode_int8_f32", f"int8 f32 ffn S={s_}", a, ffn_decode_int8_f32,
                      ffn_decode_int8_reference, [("out", BF16_ULP)],
                      cost=(q_bytes + nbytes(a[0], a[1]) + 4 * s_ * d, 4 * s_ * d * inter,
                            "int8"),
                      repeat=s_ == 64, shape=None if s_ == 64 else f"{s_} rows")
    for act in ("relu", "silu"):
        checks.kernel("ffn_decode_f32", f"f32 ffn S=4 {act} on f32 rows", ffn_args(4, act, f32),
                      ffn_decode_f32, ffn_decode_reference, [("out", tol)])
        checks.kernel("ffn_decode_int8_f32", f"int8 f32 ffn S=4 {act}", ffn_q_args(4, act),
                      ffn_decode_int8_f32, ffn_decode_int8_reference, [("out", BF16_ULP)])

    def ctx_args(b, l, hd, int8=False):
        """A layer's f32 cache: row b's prompt in its first slots, bucket
        padding to l // 2, generated tokens to the stale slot l - 1."""
        d_ = (d // hd) * hd
        q, k_new, v_new = randn(b, d_), randn(b, d_), randn(b, d_)
        k, v = randn(b, l, d_), randn(b, l, d_)
        lens = torch.randint(1, l // 2 + 1, (b, 1), generator=g, device=dev)
        slots = torch.arange(l, device=dev)[None, :]
        valid = (slots < lens) | ((slots >= l // 2) & (slots < l - 1))
        bias = torch.where(valid, 0.0, NEG).float().contiguous()
        if not int8:
            return (q, k, v, k_new, v_new, bias, hd)
        (kq, ks), (vq, vs) = quantize_heads(k, hd), quantize_heads(v, hd)
        return (q, kq, vq, k_new, v_new, bias, ks.transpose(1, 2).contiguous(),
                vs.transpose(1, 2).contiguous(), hd)

    def int8_plain(q, k, v, k_new, v_new, bias, ks, vs, hd):
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, hd, ks, vs)

    a = ctx_args(5, 37, 64)
    checks.sensitive("f32 decode attention", mha_decode_ctx_reference, a, {
        "self-term": a[:3] + (torch.zeros_like(a[3]), torch.zeros_like(a[4])) + a[5:],
        "mask": a[:5] + (torch.zeros_like(a[5]),) + a[6:]}, [("ctx", tol)])
    library_ms = None
    for hd in (64, 128):
        for b, l in ((64, 96), (1, 88)):
            a = ctx_args(b, l, hd)
            timed = hd == 64 and b == 64
            cost = (nbytes(*a[:6]) + nbytes(a[0]), 4 * b * l * a[0].shape[1], "f32")
            checks.kernel("mha_decode_ctx_f32", f"f32 decode attention B={b} L={l} Dh={hd}", a,
                          mha_decode_ctx_f32, mha_decode_ctx_reference, [("ctx", tol)],
                          cost=cost, repeat=timed,
                          shape=None if timed else f"B={b} L={l} Dh={hd}")
            if timed:
                library_ms = sdpa_f32_decode_ms(a, card)
            a = ctx_args(b, l, hd, int8=True)
            checks.kernel("mha_decode_ctx_int8_f32",
                          f"f32 decode attention, int8 cache, B={b} L={l} Dh={hd}", a,
                          mha_decode_ctx_int8_f32, int8_plain, [("ctx", tol)],
                          cost=(nbytes(*a[:8]) + nbytes(a[0]), 4 * b * l * a[0].shape[1],
                                "int8") if timed else None,
                          repeat=timed)

    for rows, layer_norm in ((2048, True), (64, True), (2048, False), (1, True)):
        x = randn(rows, d, std=2.0)
        w_ = 1 + randn(d, std=0.1)
        b_ = randn(d, std=0.1) if layer_norm else None
        timed = rows == 2048 and layer_norm
        checks.kernel("ln_quantize_f32",
                      f"f32 norm + quantize {rows} x {d} {'LayerNorm' if layer_norm else 'RMS'}",
                      (x, w_, b_, eps), ln_quantize_f32, ln_quantize_reference,
                      [("q", "int8"), ("scale", SCALE_TOL)],
                      cost=(nbytes(x, w_, b_) + x.numel() + 4 * rows, 10 * x.numel(), "f32")
                      if timed else None, repeat=timed)
    del model, qmodel
    torch.cuda.empty_cache()
    return library_ms


def sdpa_f32_decode_ms(args, card):
    """#9 f32's library yardstick: SDPA f32 (TF32 off) over the cache with
    the new slot (the last) written, outside the timed region, under the
    same mask."""
    q, k, v, k_new, v_new, bias, hd = args
    b, l = bias.shape
    kc, vc = k.clone(), v.clone()
    kc[:, l - 1], vc[:, l - 1] = k_new, v_new
    heads4 = lambda z: z.reshape(b, -1, q.shape[1] // hd, hd).transpose(1, 2)   # noqa: E731
    keep = ((bias == 0) | (torch.arange(l, device=q.device) == l - 1))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: sdpa(heads4(q), heads4(kc), heads4(vc), attn_mask=keep))
    log(f"  library: f32 scaled_dot_product_attention over the written cache {ms:.4f} ms "
        f"(B={b} L={l}); card: {card}")
    return ms


SURFACE_TURNS = ["hello there , who are you ?", " ".join(["tell me more"] * 24)]
SURFACE_MAX_NEW = 48        # the 1.5B chats' --max-length


def surfaces_phase(card, dev, work):
    """Phase 8: the user-facing surfaces on the card, through the port's own
    entry points, in ``work`` (a temporary directory):

      1. ``cli.main(["create-model", "--target-params", "1.5B", ...])`` writes
         the 1.5B dense selective-SSM model (f32);
      2. ``cli.main(["chat", ...])`` with two turns on stdin at temperature 0
         serves it in f32 through ``InferenceEngine.stream`` (#3 and #4 in
         their f32 forms): it must have loaded the directory, launched each
         form layers x decode steps, given the first turn ``generate``'s
         tokens and the same tokens again on a repeat; TTFT and the streamed
         rate of the first turn at batch 1;
      3. the same with ``--quantize int8`` (#3 and #4 int8 with f32 rows, #6,
         and #5 in the second turn's prefill of more than 64 rows);
      4. ``cli.main(["eval", ...])``, perplexity and multiple choice, f32 and
         int8: finite numbers, #1 (and #5, #6, #7 in int8) launched;
      5. fine-tuning through ``train_from_config`` (``task_type: finetune``)
         from the 2-layer dense model at the 1.5B widths (the depth cut from
         20, since the trainer writes full checkpoints) with a vocabulary of
         512 tokens: the embeddings resized with their first 512 rows copied
         bit for bit, two updates with finite losses, #1 forward and backward
         launched;
      6. one chat turn each on 2-layer f32 MoE and MHA models at the 1.5B
         widths (#3 f32 with the moe epilogue and #10; #9 f32 and #4 f32)
         and on the MHA model in int8 (#9 over an int8 cache with f32 rows);
      7. ``UIBackend.chat``, a fine-tuning job and an AZR job (which reports
         that AZR is not ported) on the 2-layer models, with gradio stubbed.

    Returns (the launches of the kernels run here, the timings)."""
    import contextlib
    import io
    import types

    from apertis_llm_torch import cli
    from apertis_llm_torch.inference.engine import InferenceEngine
    from apertis_llm_torch.inference.ui import UIBackend, launch_ui
    from apertis_llm_torch.models.convert import save_torch_checkpoint
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import count_params, init_params
    from apertis_llm_torch.ops.kernels import (
        ffn_fused, ln_quant, mha_step, moe_ffn, moe_grouped, quant_matmul, ssm_scan, ssm_step)
    from apertis_llm_torch.training import pipeline as pipeline_mod
    from apertis_llm_torch.utils.vocab import create_minimal_vocab_file, fallback_vocab

    t_phase = time.perf_counter()
    counters = [ssm_step.ssm_decode_step, ssm_step.ssm_decode_step_int8,
                ssm_step.ssm_decode_step_f32, ssm_step.ssm_decode_step_int8_f32,
                ffn_fused.ffn_decode, ffn_fused.ffn_decode_int8, ffn_fused.ffn_decode_f32,
                ffn_fused.ffn_decode_int8_f32, mha_step.mha_decode_ctx,
                mha_step.mha_decode_ctx_int8, mha_step.mha_decode_ctx_f32,
                mha_step.mha_decode_ctx_int8_f32, ln_quant.ln_quantize, ln_quant.ln_quantize_f32,
                quant_matmul.quant_matmul, quant_matmul.quant_matmul_dyn_pre_q,
                ssm_scan.selective_scan_fwd, ssm_scan.selective_scan_bwd,
                moe_ffn.expert_ffn_fat, moe_grouped.expert_ffn_grouped]
    total = collections.Counter()

    def reset():
        for f in counters:
            f.launches = 0

    def read(label):
        got = {f.__name__: f.launches for f in counters if f.launches}
        total.update(got)
        log(f"  {label}: launches {got}")
        return collections.Counter(got)

    def expect(label, got, want):
        for name, n in want.items():
            ok = got[name] == n if n is not None else got[name] > 0
            if not ok:
                raise RuntimeError(f"{label}: {name} launched {got[name]} times, expected "
                                   f"{'some' if n is None else n}")
        log(f"  {label}: {', '.join(f'{k} {got[k]}' for k in want)} as expected ok")

    streams = []
    plain_stream = InferenceEngine.stream

    def timed_stream(self, input_ids, *args, **kw):
        rec = {"prompt": np.asarray(input_ids), "kw": dict(kw), "tokens": []}
        streams.append(rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tok in plain_stream(self, input_ids, *args, **kw):
            if not rec["tokens"]:
                rec["ttft_s"] = time.perf_counter() - t0
            rec["tokens"].append(tok)
            yield tok
        rec["total_s"] = time.perf_counter() - t0

    def run_chat(model_dir, turns, *flags, max_new=SURFACE_MAX_NEW):
        stdin, out = io.StringIO("\n".join([*turns, "exit"]) + "\n"), io.StringIO()
        saved = sys.stdin
        sys.stdin = stdin
        try:
            with contextlib.redirect_stdout(out):
                iface = cli.main(["chat", "--model-path", model_dir, "--temperature", "0",
                                  "--max-length", str(max_new), *flags])
        finally:
            sys.stdin = saved
        if iface.actual_model_path_loaded != model_dir:
            raise RuntimeError(f"chat served {iface.actual_model_path_loaded}, not {model_dir}")
        if out.getvalue().count("Apertis: ") != len(turns):
            raise RuntimeError(f"chat printed {out.getvalue()!r}")
        return iface

    def steps_of(recs):
        return sum(len(r["tokens"]) - 1 for r in recs)

    def free(*objs):
        del objs
        gc.collect()
        torch.cuda.empty_cache()

    def write_model(cfg, path):
        tree = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 80), device=dev)
        save_torch_checkpoint(tree, cfg, path, filename="model.pt")
        create_minimal_vocab_file(os.path.join(path, "vocab.json"), size=4)
        free(tree)

    timings = {}
    InferenceEngine.stream = timed_stream
    try:
        # 1. create-model.
        big = os.path.join(work, "dense-1.5B")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            config = cli.main(["create-model", "--target-params", "1.5B", "--attention-type",
                               "selective_ssm", "--output-dir", big])
        n_layers = config.num_hidden_layers
        tree_size = os.path.getsize(os.path.join(big, "model.pt"))
        timings["create_model_s"] = time.perf_counter() - t0
        log(f"  create-model: 1.5B dense selective SSM, hidden {config.hidden_size}, "
            f"{n_layers} layers, {tree_size / 1e9:.2f} GB of f32 in "
            f"{timings['create_model_s']:.1f} s")

        # 2-3. chat in f32, then int8.
        for flags, label in (((), "f32"), (("--quantize", "int8"), "int8")):
            reset()
            first = len(streams)
            t0 = time.perf_counter()
            iface = run_chat(big, SURFACE_TURNS, *flags)
            timings[f"chat_{label}_s"] = time.perf_counter() - t0
            turns = streams[first:first + 2]
            got = read(f"chat {label}")
            steps = steps_of(turns)
            if label == "f32":
                if count_params(iface.params) != 1_130_162_104:
                    raise RuntimeError(f"the 1.5B tree has {count_params(iface.params):,} "
                                       "parameters")
                expect("chat f32", got, {"ssm_decode_step_f32": n_layers * steps,
                                         "ffn_decode_f32": n_layers * steps,
                                         "selective_scan_fwd": 2 * n_layers,
                                         "ssm_decode_step": 0, "ffn_decode": 0})
            else:
                expect("chat int8", got, {"ssm_decode_step_int8_f32": n_layers * steps,
                                          "ffn_decode_int8_f32": n_layers * steps,
                                          "quant_matmul": None, "ln_quantize_f32": None,
                                          "ssm_decode_step_int8": 0, "ffn_decode_int8": 0})
            rec = turns[0]
            ids = rec["prompt"]
            gen_kw = {k: v for k, v in rec["kw"].items()}
            again = list(iface.engine.stream(ids, **gen_kw))
            ref = iface.engine.generate(ids, **gen_kw)[0, ids.shape[1]:].tolist()
            if rec["tokens"] != ref or again != rec["tokens"]:
                raise RuntimeError(f"chat {label}: turn 1 streamed {rec['tokens'][:8]}..., "
                                   f"generate gave {ref[:8]}..., a repeat {again[:8]}...")
            n = len(rec["tokens"])
            rate = (n - 1) / (rec["total_s"] - rec["ttft_s"]) if n > 1 else float("nan")
            timings[f"chat_{label}"] = {"prompt_tokens": int(ids.shape[1]), "tokens": n,
                                        "ttft_ms": rec["ttft_s"] * 1e3,
                                        "streamed_tokens_per_s": rate}
            log(f"  chat {label}: turn 1 ({ids.shape[1]} prompt tokens) streamed {n} tokens "
                f"equal to generate's and to a repeat ok; TTFT {rec['ttft_s'] * 1e3:.1f} ms, "
                f"{rate:.1f} tokens/s streamed at batch 1; turn 2 {len(turns[1]['tokens'])} "
                f"tokens from {turns[1]['prompt'].shape[1]} prompt tokens; card: {card}")
            free(iface)

        # 4. eval, perplexity and multiple choice, f32 and int8.
        ppl = os.path.join(work, "ppl.jsonl")
        mc = os.path.join(work, "mc.jsonl")
        rng = np.random.default_rng(SEED + 81)
        words = ["alpha", "beta", "gamma", "delta", "<eos>", "<pad>", "<bos>"]
        with open(ppl, "w", encoding="utf-8") as f:
            for n in (5, 40, 90, 17, 130, 60):
                f.write(json.dumps({"text": " ".join(rng.choice(words, n))}) + "\n")
        with open(mc, "w", encoding="utf-8") as f:
            for i in range(3):
                f.write(json.dumps({"question": " ".join(rng.choice(words, 12)),
                                    "choices": [" ".join(rng.choice(words, 3 + j))
                                                for j in range(4)],
                                    "answer": i % 4}) + "\n")
        for flags, label in (((), "f32"), (("--quantize", "int8"), "int8")):
            for data, task, calls in ((ppl, "perplexity", 2), (mc, "multiple_choice", 3)):
                reset()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    result = cli.main(["eval", "--model-path", big, "--data", data, "--task", task,
                                       "--batch-size", "4", *flags])
                timings[f"eval_{task}_{label}_s"] = time.perf_counter() - t0
                got = read(f"eval {task} {label}")
                values = [v for v in result.values() if isinstance(v, float)]
                if not values or not all(np.isfinite(values)):
                    raise RuntimeError(f"eval {task} {label}: {result}")
                want = {"selective_scan_fwd": n_layers * calls}
                if label == "int8":
                    want.update({"ln_quantize_f32": None, "quant_matmul": None,
                                 "quant_matmul_dyn_pre_q": None})
                expect(f"eval {task} {label}", got, want)
                log(f"  eval {task} {label}: {result}")
                gc.collect()
                torch.cuda.empty_cache()

        # 5. fine-tuning from the 2-layer dense model with 512 tokens.
        small = os.path.join(work, "dense-2")
        dims = calculate_model_dimensions("1.5B", 32000)
        dense2 = dense_preset_config(dims)
        dense2.num_hidden_layers, dense2.dtype, dense2.param_dtype = 2, "float32", "float32"
        write_model(dense2, small)
        vocab = os.path.join(work, "vocab512.json")
        with open(vocab, "w", encoding="utf-8") as f:
            json.dump(fallback_vocab(512), f)
        train = os.path.join(work, "sft.jsonl")
        with open(train, "w", encoding="utf-8") as f:
            for i in range(8):
                f.write(json.dumps({"instruction": " ".join(f"<tok{5 + (i * 7 + j) % 500}>"
                                                             for j in range(20)),
                                    "output": " ".join(f"<tok{9 + (i * 3 + j) % 500}>"
                                                       for j in range(30))}) + "\n")
        resized = {}
        plain_resize = pipeline_mod.resize_embeddings

        def checked_resize(params, cfg, new_vocab, generator=None):
            out = plain_resize(params, cfg, new_vocab, generator)
            old, new = params["embed"]["tok"], out["embed"]["tok"]
            resized.update(old=tuple(old.shape), new=tuple(new.shape),
                           rows_equal=bool(torch.equal(new[:new_vocab], old[:new_vocab])))
            return out

        ft_config = os.path.join(work, "finetune.json")
        with open(ft_config, "w", encoding="utf-8") as f:
            json.dump({"data_config": {"train_data_path": train, "tokenizer_path": vocab,
                                       "max_length": 64},
                       "model_config": {},
                       "training_config": {"task_type": "finetune",
                                           "pretrained_model_path_for_finetune": small,
                                           "output_dir": os.path.join(work, "ft"),
                                           "batch_size": 4, "gradient_accumulation_steps": 1,
                                           "num_epochs": 1, "learning_rate": 1e-4,
                                           "device": "cuda"}}, f)
        reset()
        pipeline_mod.resize_embeddings = checked_resize
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                history = cli.main(["train", "--config", ft_config])
        finally:
            pipeline_mod.resize_embeddings = plain_resize
        timings["finetune_s"] = time.perf_counter() - t0
        got = read("fine-tune")
        losses = history.get("step_losses", [])
        if (resized.get("new") != (512, dims["hidden_size"]) or not resized.get("rows_equal")
                or len(losses) != 2 or not np.all(np.isfinite(losses))):
            raise RuntimeError(f"fine-tune: resize {resized}, losses {losses}")
        expect("fine-tune", got, {"selective_scan_bwd": 2 * 2, "selective_scan_fwd": None})
        log(f"  fine-tune: embeddings {resized['old']} -> {resized['new']}, the first 512 rows "
            f"copied bit for bit ok; 2 updates, losses {losses} "
            f"({'falling' if losses[1] < losses[0] else 'not falling'}, finite ok) in "
            f"{timings['finetune_s']:.1f} s")

        # 6. 2-layer f32 MoE and MHA chats at the 1.5B widths, MHA also int8.
        moe_dir, mha_dir = os.path.join(work, "moe-2"), os.path.join(work, "mha-2")
        moe2 = moe_preset_config(calculate_model_dimensions("1.5B", 32000,
                                                            use_expert_system=True))
        mha2 = mha_preset_config(dims)
        for cfg, path in ((moe2, moe_dir), (mha2, mha_dir)):
            cfg.num_hidden_layers, cfg.dtype, cfg.param_dtype = 2, "float32", "float32"
            write_model(cfg, path)
        for path, flags, label, want in (
                (moe_dir, (), "MoE f32", {"ssm_decode_step_f32": "steps",
                                          "expert_ffn_fat": None}),
                (mha_dir, (), "MHA f32", {"mha_decode_ctx_f32": "steps",
                                          "ffn_decode_f32": "steps"}),
                (mha_dir, ("--quantize", "int8"), "MHA int8",
                 {"mha_decode_ctx_int8_f32": "steps", "ffn_decode_int8_f32": "steps"})):
            reset()
            first = len(streams)
            iface = run_chat(path, SURFACE_TURNS[:1], *flags, max_new=16)
            steps = 2 * steps_of(streams[first:first + 1])
            expect(f"chat {label}", read(f"chat {label}"),
                   {k: steps if v == "steps" else v for k, v in want.items()})
            if label == "MHA int8":
                mha_iface = iface
            else:
                free(iface)

        # 7. the UI backend, gradio stubbed.
        backend = UIBackend(mha_iface)
        history, cleared = backend.chat("hello there", None, 8, 0.0, 50, 1.0, [])
        if len(history) != 1 or cleared != "":
            raise RuntimeError(f"UIBackend.chat gave {history}")
        launched = []
        stub = types.ModuleType("gradio")

        class Component:
            def __init__(self, *a, **k):
                pass

            def click(self, *a, **k):
                pass

            submit = click

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def launch(self, **k):
                launched.append(k)

        for name in ("Blocks", "Tabs", "TabItem", "Row", "Accordion", "Column", "Markdown",
                     "Chatbot", "Textbox", "Button", "Image", "Slider", "Number", "Checkbox",
                     "Dropdown"):
            setattr(stub, name, Component)
        saved_gradio = sys.modules.get("gradio")
        sys.modules["gradio"] = stub
        try:
            launch_ui(mha_iface, port=7860)
        finally:
            if saved_gradio is None:
                del sys.modules["gradio"]
            else:
                sys.modules["gradio"] = saved_gradio
        if not launched:
            raise RuntimeError("launch_ui did not launch the stubbed app")
        reset()
        msg = backend.start_finetuning(small, train, "", False, vocab, "", 64,
                                       os.path.join(work, "ui_ft"), 4, 1e-4, 1, 1, False)
        azr = backend.start_azr("gpt2", 64, 1, 1, 128, "standard_mha", 1, 1, 1,
                                os.path.join(work, "ui_azr"))
        for job in (backend.finetune_job, backend.azr_job):
            job.thread.join(timeout=300)
            if job.running():
                raise RuntimeError(f"{job.name} did not finish in 300 s")
        ft_status, azr_status = backend.finetune_job.status(), backend.azr_job.status()
        if "finished" not in ft_status or "FAILED" not in azr_status or \
                "not ported" not in azr_status:
            raise RuntimeError(f"UI jobs: {ft_status!r}, {azr_status!r}")
        expect("UI fine-tuning job", read("UI fine-tuning job"),
               {"selective_scan_bwd": 2 * 2})
        log(f"  UI: chat ok; launch_ui bound the stubbed gradio app ok; {msg} -> finished "
            f"ok; {azr} -> {azr_status.splitlines()[-1][:120]} ok")
        free(mha_iface, backend)
    finally:
        InferenceEngine.stream = plain_stream
        reset()
    timings["phase_s"] = time.perf_counter() - t_phase
    return dict(total), timings


def surfaces_main() -> int:
    """``--surfaces``: the build, phase 3i (the f32 forms' checks) and phase
    8 (the surfaces) alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.ops.kernels import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"card: {card}; build in {time.perf_counter() - t0:.1f} s")
    checks = KernelChecks(card)
    dev = torch.device("cuda", 0)
    f32_forms_phase(checks, dev)
    log(f"phase 3i done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as work:
        launches, timings = surfaces_phase(card, dev, work)
    log(f"phase 8 done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"surfaces": {"launches": launches, "timings": timings,
                                   "errs": checks.errs, "times": checks.times}}))
    print(card)
    return 0


class KernelChecks:
    """The kernel checks' records: ``errs`` (kernel -> worst error),
    ``times`` (kernel -> (ms, plain_ms, bound_ms, bound_by, device_ms) at
    the timed shape) and ``shape_times`` (kernel -> other shapes' times)."""

    def __init__(self, card):
        self.card = card
        self.errs, self.times, self.shape_times = {}, {}, {}

    def kernel(self, key, label, args, kernel, plain, tols, cost=None, repeat=False,
               shape=None):
        """Run the kernel and its plain version on ``args``, compare each
        output with its tolerance, and time both; with ``cost`` (bytes,
        operations, type) this is the shape the report gives, or, named
        ``shape``, one more shape the report lists beside it; with
        ``repeat`` a second run must give the same bits."""
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if len(got) != len(ref):
            raise RuntimeError(f"{label}: {len(got)} outputs, plain version {len(ref)}")
        for (out_name, tol), a, b in zip(tols, got, ref):
            cmp = compare_int8 if tol == "int8" else compare
            self.errs[key] = max(self.errs.get(key, 0.0), cmp(f"{label} {out_name}", a, b, tol))
        if repeat:
            again = kernel(*args)
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"{label}: a second run gave other bits")
            log(f"  {label}: a second run gives the same bits ok")
        k_ms = cuda_ms(lambda: kernel(*args))
        p_ms = cuda_ms(lambda: plain(*args))
        line = f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
        if cost is not None:
            b_ms, by = bound(*cost)
            d_ms = device_ms(lambda: kernel(*args))
            if shape is None:
                self.times[key] = (k_ms, p_ms, b_ms, by, d_ms)
            else:
                self.shape_times.setdefault(key, {})[shape] = {
                    "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": by}
            line += (f", device {d_ms:.4f} ms" if d_ms is not None else ", device not measured")
            line += f", bound {b_ms:.4f} ms ({by})"
        log(f"{line}; card: {self.card}")

    def sensitive(self, label, plain, args, variants, tols, factor=1):
        """Each variant drops one term from ``args`` (or is a function that
        computes the plain version without it); the plain version's outputs
        must then move by more than ``factor`` times a kernel check's
        tolerance, so a kernel that dropped the term would fail that check
        (an int8 output must change more levels, or on more elements, than it
        may)."""
        base = plain(*args)
        base = base if isinstance(base, tuple) else (base,)
        for term, changed in variants.items():
            out = changed() if callable(changed) else plain(*changed)
            out = out if isinstance(out, tuple) else (out,)
            moved = []
            for (name, tol), o, b in zip(tols, out, base):
                if tol == "int8":
                    dq = (o.int() - b.int()).abs()
                    moved.append((float((dq > 0).float().mean()), INT8_FLIP_SHARE, name)
                                 if int(dq.max()) <= INT8_MAX_DQ else
                                 (float(dq.max()), float(INT8_MAX_DQ), name))
                else:
                    moved.append((float((o.float() - b.float()).abs().max()),
                                  factor * tol * float(b.float().abs().max()), name))
            shift, bound_, name = max(moved, key=lambda m: m[0] / max(m[1], 1e-30))
            ok = shift > bound_
            log(f"  sensitivity {label}, {term}: {name} moves {shift:.3e} "
                f"(tolerance {bound_:.3e}, {shift / max(bound_, 1e-30):.2f} x) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label}: the check cannot see {term}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.config import ApertisConfig
    from apertis_llm_torch.inference.engine import InferenceEngine, _round_up_bucket
    from apertis_llm_torch.models import apertis as apertis_model
    from apertis_llm_torch.models.convert import (
        from_jax_params, load_pretrained, params_tree, save_torch_checkpoint)
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.moe_fuse import fuse_one_fat
    from apertis_llm_torch.models.params import count_params, init_params
    from apertis_llm_torch.models.quantize import (
        int4_ffn_pack, quantize_params, quantize_weight)
    from apertis_llm_torch.ops import moe as moe_ops
    from apertis_llm_torch.ops.kernels import _build
    from apertis_llm_torch.ops.kernels.ffn_fused import (
        ffn_decode, ffn_decode_int4, ffn_decode_int4_reference, ffn_decode_int8,
        ffn_decode_int8_reference, ffn_decode_reference, ffn_quant_resources, pick_block_n)
    from apertis_llm_torch.ops.kernels.ffn_fused import bf16_plan as ffn_bf16_plan
    from apertis_llm_torch.ops.kernels.ffn_fused import quant_plan as ffn_quant_plan
    from apertis_llm_torch.ops.kernels.flash_attention import (
        BF16_KERNELS, F32_KERNELS, flash_attention_dkv, flash_attention_dkv_f32,
        flash_attention_dkv_reference, flash_attention_dq, flash_attention_dq_f32,
        flash_attention_dq_reference, flash_attention_fwd, flash_attention_fwd_f32,
        flash_attention_fwd_reference, flash_attention_resources)
    from apertis_llm_torch.ops.kernels.ln_quant import (
        ln_plan, ln_quantize, ln_quantize_reference, ln_quantize_resources)
    from apertis_llm_torch.ops.kernels.ln_quant import max_width as ln_max_width
    from apertis_llm_torch.ops.kernels.mha_step import (
        NEG, mha_decode_ctx, mha_decode_ctx_int8, mha_decode_ctx_reference, quantize_heads)
    from apertis_llm_torch.ops.kernels.moe_ffn import (
        expert_ffn_dense, expert_ffn_dense_reference, expert_ffn_fat, expert_ffn_fat_int4,
        expert_ffn_fat_int4_reference, expert_ffn_fat_reference, fat_block_n, fat_plan,
        fat_resources)
    from apertis_llm_torch.ops.kernels.moe_grouped import (
        TILE, expert_ffn_grouped, expert_ffn_grouped_reference)
    from apertis_llm_torch.ops.kernels.ssm_scan import (
        BWD_CHUNK, CARRY_FWD_CHUNK, FWD_CHUNK, selective_scan_bwd, selective_scan_bwd_reference, selective_scan_bwd_smem,
        selective_scan_carry_bwd, selective_scan_carry_bwd_reference, selective_scan_carry_fwd,
        selective_scan_carry_fwd_reference, selective_scan_fwd, selective_scan_fwd_reference)
    from apertis_llm_torch.ops.kernels.quant_matmul import (
        fused_plan_on, quant_matmul, quant_matmul_dyn_fused, quant_matmul_dyn_fused_reference,
        quant_matmul_dyn_pre_q, quant_matmul_dyn_pre_q_reference, quant_matmul_fused_resources,
        quant_matmul_reference)
    from apertis_llm_torch.ops.kernels.ssm_step import (
        ssm_decode_step, ssm_decode_step_int8, ssm_decode_step_reference, ssm_step_resources,
        step_plan)
    from apertis_llm_torch.ops.activations import get_activation
    from apertis_llm_torch.ops.norms import layer_norm, rms_norm
    from apertis_llm_torch.ops.quant import fuses_pre_norm, int_mm, quantize_rows, resolve_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

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
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
        f"({len(_build.SOURCES)} nvcc processes in parallel)")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. the 1.5B model and the kernel checks ----------------------------
    dims = calculate_model_dimensions("1.5B", 32000)
    config = dense_preset_config(dims)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_params(config, gen, device=dev, dtype=torch.bfloat16)
    n_params = count_params(tree)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 2))
    model = from_jax_params(tree, config, device=dev, dtype=torch.bfloat16)
    qtree = quantize_params(tree)
    del tree
    qmodel = from_jax_params(qtree, config, device=dev, dtype=torch.bfloat16)
    del qtree
    torch.cuda.synchronize()
    log(f"model: {n_params:,} parameters, hidden {config.hidden_size}, "
        f"{config.num_hidden_layers} layers, {config.num_attention_heads} heads, "
        f"d_inner {config.ssm_d_inner}, dt_rank {config.ssm_dt_rank}, FFN "
        f"{config.intermediate_size}, bf16 and int8 (quantize_params on the card), "
        f"built in {time.perf_counter() - t0:.1f} s")
    qlayer = qmodel.layers[0]
    int8_bytes = sum(nbytes(p) for p in qlayer.parameters() if p.dtype == torch.int8)
    scale_bytes = sum(nbytes(m.w_s) for m in qlayer.modules() if hasattr(m, "w_s"))
    bf16_bytes = sum(nbytes(p) for p in model.layers[0].parameters())
    log(f"int8 layer: {int8_bytes:,} bytes of int8 weights + {scale_bytes:,} bytes of "
        f"f32 scales + {nbytes(*(p for p in qlayer.parameters() if p.dtype == torch.bfloat16)):,}"
        f" bytes of bf16 (norms, conv, dt_proj, A_log, D, biases); bf16 layer "
        f"{bf16_bytes:,} bytes")

    layer = model.layers[0]
    mixer = layer.attn.mixer_weights()
    qmixer = qlayer.attn.mixer_weights()
    ffn_norm = layer.ffn.pre_norm.weights()
    heads, n, c, d = (config.num_attention_heads, config.ssm_d_state,
                      config.ssm_d_inner, config.hidden_size)
    r_dt, inter = config.ssm_dt_rank, config.intermediate_size
    eps = config.layer_norm_eps
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0, gen=None):
        return (torch.randn(shape, generator=gen or g, device=dev) * std).to(dtype)

    checks = KernelChecks(card)
    errs, times, shape_times = checks.errs, checks.times, checks.shape_times
    check_kernel, check_sensitive = checks.kernel, checks.sensitive

    log("kernel checks (bf16 in, f32 carry/accumulation; int8 with exact int32 sums), "
        "CUDA-event times:")

    def scan_inputs(b, l, bc_dtype=torch.bfloat16, out_dtype=torch.bfloat16, a_log=None,
                    gen=None):
        gen = gen or g
        a_log = layer.attn.A_log if a_log is None else a_log
        hs_, ns_ = a_log.shape
        lens = {4: [7, 19, 32, 45], 64: [32] * 64}.get(
            b, torch.randint(1, l + 1, (b,), generator=gen, device=dev).tolist())
        mask = (torch.arange(l, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        delta = torch.nn.functional.softplus(randn(b, l, hs_, dtype=torch.float32, gen=gen)
                                             - 4.0)
        a_cont = -torch.exp(a_log.float())
        return (delta, a_cont, randn(b, l, hs_, ns_, dtype=bc_dtype, gen=gen),
                randn(b, l, hs_, ns_, dtype=bc_dtype, gen=gen), mask, out_dtype)

    def scan_cost(args):
        delta, a_cont, bt, ct, mask, out_dtype = args[:6]
        want_h = len(args) > 6 and args[6]
        y_bytes = bt.numel() * torch.tensor([], dtype=out_dtype).element_size()
        return (nbytes(delta, a_cont, bt, ct, mask) + y_bytes
                + bt.shape[0] * bt.shape[2] * bt.shape[3] * 4
                + (4 * bt.numel() if want_h else 0), 6 * bt.numel(), "f32")

    f32, bf16 = torch.float32, torch.bfloat16
    for (b, l), bc_dtype, out_dtype in [((4, 64), bf16, bf16), ((64, 32), bf16, bf16),
                                        ((5, 37), bf16, bf16), ((5, 37), bf16, f32),
                                        ((5, 37), f32, bf16), ((5, 37), f32, f32)]:
        y_tol = BF16_ULP if out_dtype == bf16 else SCAN_F32_TOL
        args = scan_inputs(b, l, bc_dtype, out_dtype)
        check_kernel("selective_scan_fwd",
                     f"scan B={b} L={l} b/c {str(bc_dtype)[6:]} y {str(out_dtype)[6:]}",
                     args, selective_scan_fwd, selective_scan_fwd_reference,
                     [("y", y_tol), ("h_last", SCAN_F32_TOL)],
                     cost=scan_cost(args) if (b, l) == (64, 32) else None)

    step_tols = [("h_out", BF16_ULP), ("x_proj", BF16_ULP), ("ssm", F32_TOL),
                 ("ffn_in", BF16_ULP)]
    # int8 layout: the FFN input is (x_q, x_s); x_s is the absmax of a
    # bf16-rounded row over 127, so a flipped bf16 rounding moves it by one
    # bf16 step.
    step_tols_q = step_tols[:3] + [("x_q", "int8"), ("x_s", BF16_ULP)]
    mixer_rms = mixer._replace(norm_b=None)
    qmixer_rms = qmixer._replace(norm_b=None)
    ffn_norm_rms = (ffn_norm[0], None)

    def step_inputs(b, w=mixer, fn=ffn_norm):
        return (randn(b, d), randn(b, config.ssm_conv_kernel - 1, c),
                randn(b, c, dtype=torch.float32), w, eps, fn)

    def step_cost(args):
        h, conv, ssm, w, _, fn = args[:6]
        router = args[7] if len(args) > 7 else None
        rows, d_, c_, r_ = h.shape[0], h.shape[1], w.inx_w.shape[1], w.dt_w.shape[0]
        weights = [getattr(w, f) for f in w._fields if isinstance(getattr(w, f), torch.Tensor)]
        quant = w.quantized
        outs = nbytes(h, ssm) + rows * c_ * conv.element_size()
        macs = d_ * c_ * 2 + c_ * (r_ + 2 * c_) + c_ * d_
        if router is not None:     # x_q, x_s and the combine weights
            outs += rows * (d_ + 4 + 4 * router.w.shape[1])
            macs += d_ * router.w.shape[1]
        elif fn is not None:
            outs += rows * d_ * (1 if quant else 2) + (rows * 4 if quant else 0)
        return (nbytes(h, conv, ssm, *weights, *(fn or ()), *(router or ())) + outs,
                2 * rows * macs, "int8" if quant else "bf16")

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
    # The bf16 layout (csrc/ssm_step.cu's row kernels and bf16 wgmma
    # products): ffn_mode none and dense with both norms at 4, 5, 64 and 256
    # rows (moe in phase 3b), twice at 64 rows for the same bits.
    for b in (4, 5, 64, 256):
        for w, fn, label in [(mixer, ffn_norm, "LayerNorm, dense"),
                             (mixer, None, "LayerNorm, ffn_mode none"),
                             (mixer_rms, ffn_norm_rms, "RMSNorm, dense"),
                             (mixer_rms, None, "RMSNorm, ffn_mode none")]:
            args = step_inputs(b, w, fn)
            timed = b == 64 and label == "LayerNorm, dense"
            check_kernel("ssm_decode_step", f"decode step B={b} {label}", args,
                         ssm_decode_step, ssm_decode_step_reference,
                         step_tols if fn is not None else step_tols[:3],
                         cost=step_cost(args) if timed else None, repeat=b == 64)

    args = step_inputs(5, qmixer)

    def qwithout(**terms):
        return args[:3] + (qmixer._replace(**terms),) + args[4:]

    check_sensitive("int8 decode step", ssm_decode_step_reference, args, {
        f"{name} w_s": qwithout(**{name: torch.ones_like(getattr(qmixer, name))})
        for name in ("inx_s", "inz_s", "xparam_s", "out_s")}, step_tols_q)
    # The int8 layout (csrc/ssm_step.cu's row kernels and int8 wgmma
    # products): every ffn_mode (moe in phase 3b) and both norms at 4, 5, 64
    # and 256 rows, each run twice for the same bits.
    for b in (4, 5, 64, 256):
        for w, fn, label in [(qmixer, ffn_norm, "LayerNorm, dense"),
                             (qmixer, None, "LayerNorm, ffn_mode none"),
                             (qmixer_rms, ffn_norm_rms, "RMSNorm, dense"),
                             (qmixer_rms, None, "RMSNorm, ffn_mode none")]:
            args = step_inputs(b, w, fn)
            timed = b == 64 and label == "LayerNorm, dense"
            check_kernel("ssm_decode_step_int8", f"int8 decode step B={b} {label}", args,
                         ssm_decode_step, ssm_decode_step_reference,
                         step_tols_q if fn is not None else step_tols_q[:3],
                         cost=step_cost(args) if timed else None, repeat=True)

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
        args = ffn_inputs(s_, act)
        check_kernel("ffn_decode", f"ffn S={s_} {act}", args, ffn_decode,
                     ffn_decode_reference, [("out", BF16_ULP)],
                     cost=(nbytes(w1.w, w1.b, w2.w, w2.b) + 2 * nbytes(args[0]),
                           4 * s_ * d * inter, "bf16") if s_ == 64 else None,
                     repeat=s_ == 64)

    q1, q2 = qlayer.ffn.w1, qlayer.ffn.w2

    def ffn_q_inputs(s, act=config.hidden_act, weights=(q1.w_q, q1.w_s, q1.b, q2.w_q,
                                                       q2.w_s, q2.b)):
        x_q, x_s = quantize_rows(randn(s, d))
        return (x_q, x_s, *weights, act)

    def ffn_int8_without_hs(x_q, x_s, w1_q, w1_s, b1, w2_q, w2_s, b2, act):
        """The plain int8 FFN with each tile's hidden scale hs left out of
        the accumulation."""
        bn = pick_block_n(w1_q.shape[1])
        h = get_activation(act)(int_mm(x_q, w1_q).float() * x_s * w1_s + b1.float())
        acc = 0.0
        for t0 in range(0, h.shape[1], bn):
            hq, _ = quantize_rows(h[:, t0:t0 + bn])
            acc = acc + int_mm(hq, w2_q[t0:t0 + bn]).float()
        return ((acc * w2_s + b2.float()).to(torch.bfloat16),)

    args = ffn_q_inputs(5)
    check_sensitive("int8 ffn", ffn_decode_int8_reference, args, {
        "x_s": (args[0], torch.ones_like(args[1])) + args[2:],
        "w1_s": args[:3] + (torch.ones_like(q1.w_s),) + args[4:],
        "w2_s": args[:6] + (torch.ones_like(q2.w_s),) + args[7:],
        "b1": args[:4] + (torch.zeros_like(q1.b),) + args[5:],
        "b2": args[:7] + (torch.zeros_like(q2.b),) + args[8:],
        "per-tile hs": lambda: ffn_int8_without_hs(*args),
    }, [("out", BF16_ULP)])
    log(f"  int8 ffn hidden tiles: I={inter} -> {inter // pick_block_n(inter)} tiles of "
        f"{pick_block_n(inter)}")
    # The int8 layout (csrc/ffn_fused.cu's int8 wgmma products) at 4, 5, 64
    # and 256 rows, at I = 9728 (19 hidden tiles of 512) and 1536 (two of
    # 768), GELU, ReLU and SiLU, each run twice for the same bits.
    ffn_cases = [(s_, config.hidden_act) for s_ in (4, 5, 64, 256)] + [(5, "relu"), (5, "silu")]
    for s_, act in ffn_cases:
        args = ffn_q_inputs(s_, act)
        check_kernel("ffn_decode_int8", f"int8 ffn S={s_} {act}", args, ffn_decode_int8,
                     ffn_decode_int8_reference, [("out", BF16_ULP)],
                     cost=(nbytes(*args[:8]) + s_ * d * 2, 4 * s_ * d * inter,
                           "int8") if (s_, act) == (64, config.hidden_act) else None,
                     repeat=True)
    inter2 = 1536          # two hidden tiles of 768
    wq1, ws1 = quantize_weight(randn(d, inter2, std=0.02))
    wq2, ws2 = quantize_weight(randn(inter2, d, std=0.02))
    b1_2, b2_2 = randn(inter2, std=0.1), randn(d, std=0.1)
    log(f"  int8 ffn hidden tiles: I={inter2} -> {inter2 // pick_block_n(inter2)} tiles of "
        f"{pick_block_n(inter2)}")
    for s_, act in ffn_cases:
        args = ffn_q_inputs(s_, act, weights=(wq1, ws1, b1_2, wq2, ws2, b2_2))
        check_kernel("ffn_decode_int8", f"int8 ffn S={s_} I={inter2} {act}", args,
                     ffn_decode_int8, ffn_decode_int8_reference, [("out", BF16_ULP)],
                     repeat=True)
    # The widest hidden tile pick_block_n gives, 1152 columns at I = 4608:
    # GEMM1's cluster of 9 blocks, a non-portable cluster size.
    inter3 = 4608
    wq1_3, ws1_3 = quantize_weight(randn(d, inter3, std=0.02))
    wq2_3, ws2_3 = quantize_weight(randn(inter3, d, std=0.02))
    b1_3, b2_3 = randn(inter3, std=0.1), randn(d, std=0.1)
    log(f"  int8 ffn hidden tiles: I={inter3} -> {inter3 // pick_block_n(inter3)} tiles of "
        f"{pick_block_n(inter3)}")
    for s_ in (4, 64):
        args = ffn_q_inputs(s_, weights=(wq1_3, ws1_3, b1_3, wq2_3, ws2_3, b2_3))
        check_kernel("ffn_decode_int8", f"int8 ffn S={s_} I={inter3} {config.hidden_act}",
                     args, ffn_decode_int8, ffn_decode_int8_reference, [("out", BF16_ULP)],
                     repeat=True)

    ln_tols = [("x_q", "int8"), ("x_s", SCALE_TOL)]
    pre_w, pre_b = qlayer.attn.pre_norm.weights()
    args = (randn(37, d, std=2.0), pre_w, pre_b, eps)
    check_sensitive("ln_quantize", ln_quantize_reference, args, {
        "norm weight": (args[0], torch.ones_like(pre_w), pre_b, eps),
        "norm bias": (args[0], pre_w, torch.zeros_like(pre_b), eps),
    }, ln_tols)
    # The main path's shapes (request B's LayerNorm is the report's), then
    # the widths 192, 1216 and 2432, two that are not multiples of 8 (four-
    # and one-value loads) and the widest the wrapper takes, with both norms;
    # each run twice for the same bits, with its plan's resources.
    ln_resources, ln_bit_equal = {}, {}

    def ln_check(label, rows, h_, layer_norm_, eps_, timed):
        args = (*ln_operands(rows, h_, layer_norm_, g, dev), eps_)
        plan = ln_plan(h_, rows)
        key = f"{plan.vec} x {plan.threads} x {plan.nv}"
        if key not in ln_resources:
            ln_resources[key] = ln_quantize_resources(plan)
            log(f"  ln_quantize plan (vec, threads a row, vectors a thread) {key}: "
                f"{json.dumps(ln_resources[key])}")
        check_kernel("ln_quantize", f"ln_quantize {rows} x {h_} ({label})", args, ln_quantize,
                     ln_quantize_reference, ln_tols, repeat=True,
                     cost=ln_cost(*args[:3]) if timed else None,
                     shape=None if timed == "report" else label)
        # Both versions take the row sums as f64 sums of f32 parts: the
        # kernel is expected to give the plain version's bits (reported,
        # the tolerances above being the check).
        ln_bit_equal[f"{rows} x {h_} ({label})"] = all(
            torch.equal(a, r) for a, r in zip(ln_quantize(*args), ln_quantize_reference(*args)))

    for i, (label, rows, h_, layer_norm_, eps_) in enumerate(LN_SHAPES):
        ln_check(label, rows, h_, layer_norm_, eps_, "report" if i == 0 else "shape")
    for h_ in (192, 1216, 2432, 2436, 2431, ln_max_width(8)):
        for layer_norm_ in (True, False):
            ln_check(f"width {h_}, {'LayerNorm' if layer_norm_ else 'RMSNorm'}",
                     64 if h_ > 8192 else 300, h_, layer_norm_, eps, None)
    try:
        ln_quantize(randn(2, ln_max_width(8) + 8), *ln_operands(1, ln_max_width(8) + 8, True,
                                                                 g, dev)[1:], eps)
    except ValueError as exc:
        log(f"  ln_quantize past its widest row raises: {exc} ok")
    else:
        raise RuntimeError("ln_quantize took a row wider than its plan allows")

    # The decode kernels' warm and cold times at 64 and 4 rows, and the
    # resources the card gives each of their launches.
    log("decode kernels (int8 #3, bf16, int8 and int4 #4), warm and cold weights:")
    decode = decode_times(card, qmodel, config, model)
    decode_resources = {}
    for rows in (4, 64):
        h_ = randn(rows, d)
        x_q, _ = quantize_rows(h_)
        for name, w in (("ssm_decode_step_int8", qmixer), ("ssm_decode_step", mixer)):
            for kind, plan in zip(("in", "mix", "out"), step_plan(h_, w)):
                decode_resources[f"{name} {kind} at {rows} rows"] = dict(
                    plan._asdict(), **ssm_step_resources(kind, plan, w.quantized))
        for bits in (8, 4):
            ffn_plan_ = ffn_quant_plan(x_q, d, inter, bits)
            for kind, plan in zip(("up", "down"), ffn_plan_):
                decode_resources[f"ffn_decode_int{bits} {kind} at {rows} rows"] = dict(
                    plan._asdict(), **ffn_quant_resources(bits, kind, plan))
        for kind, plan in zip(("up", "down"), ffn_bf16_plan(h_, d, inter)):
            decode_resources[f"ffn_decode {kind} at {rows} rows"] = dict(
                plan._asdict(), **ffn_quant_resources(16, kind, plan))

    def log_resources(keys):
        for key in keys:
            res = decode_resources[key]
            log(f"  resources of {key}: {res['registers']} registers a thread, "
                f"{res['shared_bytes']} bytes of shared memory and {res['threads']} threads a "
                f"block, {res['blocks_per_sm']} block(s) an SM, {res['spill_bytes']} bytes "
                f"spilled; plan rows {res['rows']}, split {res['split']}, stages "
                f"{res['stages']}, grid {tuple(res['grid'])}"
                + (f", group {res['group']}" if "group" in res else ""))

    log_resources(list(decode_resources))

    def fat_plan_resources(bits, h_, inter_):
        """The fat kernel's launches at 4 and 64 rows (GEMM1, GEMM2 and, in
        the wide form, the requantization) with what the card gives each."""
        name = "expert_ffn_fat_int4" if bits == 4 else "expert_ffn_fat"
        keys = []
        for rows in (4, 64):
            xq_ = torch.zeros((rows, h_), dtype=torch.int8, device=dev)
            plan = fat_plan(xq_, h_, inter_, n_exp, bits)
            kinds = [("up", plan.up), ("down", plan.down)]
            kinds += [("quant", plan.up)] if plan.up.split == 0 else []
            for kind, p_ in kinds:
                key = f"{name} {kind} at {rows} rows"
                decode_resources[key] = dict(p_._asdict(), group=plan.group,
                                             **fat_resources(bits, kind, p_))
                keys.append(key)
        log_resources(keys)

    # ---- 3b. the 1.5B MoE model and its kernel checks -----------------------
    mdims = calculate_model_dimensions("1.5B", 32000, use_expert_system=True)
    moe_config = moe_preset_config(mdims)
    t0 = time.perf_counter()
    tree = init_params(moe_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=bf16)
    moe_params = count_params(tree)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 4))
    moe_model = from_jax_params(tree, moe_config, device=dev, dtype=bf16)
    qtree = quantize_params(tree)
    del tree
    moe_qmodel = from_jax_params(qtree, moe_config, device=dev, dtype=bf16)
    del qtree
    for m in (moe_model, moe_qmodel):
        m.attach_moe_fat()
    torch.cuda.synchronize()
    n_exp, md, mc = moe_config.num_experts, moe_config.hidden_size, moe_config.ssm_d_inner
    m_inter = moe_config.intermediate_size
    log(f"MoE model: {moe_params:,} parameters in the tree ({mdims['calculated_params']:,} by "
        f"the factory's count), hidden {md}, {moe_config.num_hidden_layers} layers, "
        f"{moe_config.num_attention_heads} heads, d_inner {mc}, dt_rank {moe_config.ssm_dt_rank}"
        f", {n_exp} experts of {m_inter} (top-2), bf16 and int8, fat stacks attached, built "
        f"in {time.perf_counter() - t0:.1f} s")
    mlayer, mqlayer = moe_model.layers[0], moe_qmodel.layers[0]
    fat = mqlayer.ffn.experts.fat()
    log(f"MoE fat stack: {nbytes(*fat.values()):,} bytes a layer; expert tile bn = "
        f"{fat_block_n(m_inter)}")

    # Existing kernels at the MoE mixer's shapes (C and D not multiples of 64).
    for (b, l) in ((4, 64), (64, 32), (5, 37)):
        check_kernel("selective_scan_fwd", f"MoE mixer scan B={b} L={l} (C={mc})",
                     scan_inputs(b, l, a_log=mlayer.attn.A_log), selective_scan_fwd,
                     selective_scan_fwd_reference, [("y", BF16_ULP), ("h_last", SCAN_F32_TOL)])
    m_pre_w, m_pre_b = mqlayer.attn.pre_norm.weights()
    for rows in (256, 2048, 37):
        for bias, kind in [(m_pre_b, "LayerNorm"), (None, "RMSNorm")]:
            check_kernel("ln_quantize", f"MoE ln_quantize {rows} rows (D={md}) {kind}",
                         (randn(rows, md, std=2.0), m_pre_w, bias, eps), ln_quantize,
                         ln_quantize_reference, ln_tols)
    m_mixer, m_qmixer = mlayer.attn.mixer_weights(), mqlayer.attn.mixer_weights()
    m_fnorm = mlayer.ffn.pre_norm.weights()
    # The moe epilogue folds rsqrt(var2 + eps) of the FFN input into x_s; a
    # pre-norm weight three times the model's puts it near 1/3, where the x_s
    # check would see it dropped.
    m_fnorm3 = (m_fnorm[0] * 3, m_fnorm[1])
    m_router = mlayer.ffn.router_weights()
    moe_tols = step_tols[:3] + [("x_q", "int8"), ("x_s", BF16_ULP), ("comb", F32_TOL)]

    def moe_step_inputs(b, w, fn=m_fnorm3, router=m_router):
        return (randn(b, md), randn(b, moe_config.ssm_conv_kernel - 1, mc),
                randn(b, mc, dtype=torch.float32), w, eps, fn, None, router)

    def step_without_inv2(args):
        """The plain step's outputs with x_s left without the epilogue's
        rsqrt(var2 + eps), recomputed from h_out (bf16) for the check."""
        outs = ssm_decode_step_reference(*args)
        fn = args[5]
        n2 = (layer_norm(outs[0].float(), fn[0], fn[1], eps) if fn[1] is not None
              else rms_norm(outs[0].float(), fn[0], eps)).to(bf16).float()
        var = n2.var(dim=-1, unbiased=False, keepdim=True)
        return outs[:4] + (outs[4] * torch.sqrt(var + eps),) + outs[5:]

    for label, w in (("bf16", m_mixer), ("int8", m_qmixer)):
        args = moe_step_inputs(5, w)
        check_sensitive(f"{label} decode step, moe epilogue", ssm_decode_step_reference, args, {
            "router bias": args[:7] + (m_router._replace(b=torch.zeros_like(m_router.b)),),
            "inverse deviation inv2": lambda a=args: step_without_inv2(a),
        }, moe_tols)
    # Both layouts at 4, 5, 64 and 256 rows (x_param's bf16 rows of 792
    # bytes are staged by the producer's own loads), int8 twice at every
    # count and bf16 twice at 64 rows for the same bits.
    moe_cases = [(b, w, fn, label) for w in (m_mixer, m_qmixer) for b in (4, 5, 64, 256)
                 for fn, label in ((m_fnorm3, "LayerNorm"), ((m_fnorm3[0], None), "RMSNorm"))]
    for b, w, fn, label in moe_cases:
        key = "ssm_decode_step_int8_moe" if w.quantized else "ssm_decode_step_moe"
        args = moe_step_inputs(b, w._replace(norm_b=None) if fn[1] is None else w, fn)
        check_kernel(key, f"{'int8' if w.quantized else 'bf16'} decode step B={b} {label}, "
                     f"moe epilogue (D={md}, C={mc}, R={moe_config.ssm_dt_rank})", args,
                     ssm_decode_step, ssm_decode_step_reference, moe_tols,
                     cost=step_cost(args) if (b, label) == (64, "LayerNorm") else None,
                     repeat=w.quantized or b == 64)
    # The bf16 step's moe epilogue at 256 rows over FAULT2_SEEDS more seeds of
    # its inputs (ROADMAP.md section 3, fault 2): the largest combine-weight
    # error and the rows whose top-2 choice differs from the plain version's.
    # A row keeps its choice when neither side's two largest gates are near
    # a tie; there its weights are held to F32_TOL. A row whose FFN input n2
    # rounds to another bf16 value (the two sides' f32 sums of the products
    # run in other orders) can swap two experts whose gates tie to within
    # that difference: its weights, sorted, are held to F32_TOL, so that a
    # swap of experts that are not tied fails.
    fault2 = {"seeds": FAULT2_SEEDS, "max_comb_err": 0.0, "rows_top2_changed": 0,
              "max_err_same_choice": 0.0, "max_sorted_err_changed_choice": 0.0}
    for seed in range(FAULT2_SEEDS):
        gs = torch.Generator(device=dev).manual_seed(SEED + 1000 + seed)
        args = (randn(256, md, gen=gs), randn(256, moe_config.ssm_conv_kernel - 1, mc, gen=gs),
                randn(256, mc, dtype=f32, gen=gs), m_mixer, eps, m_fnorm3, None, m_router)
        comb, comb_ref = ssm_decode_step(*args)[5], ssm_decode_step_reference(*args)[5]
        changed = ((comb > 0) != (comb_ref > 0)).any(dim=1)
        err = (comb - comb_ref).abs()
        sorted_err = (comb.sort(dim=1).values - comb_ref.sort(dim=1).values).abs()
        same = float(err[~changed].max()) if bool((~changed).any()) else 0.0
        swapped = float(sorted_err[changed].max()) if bool(changed.any()) else 0.0
        tol = F32_TOL * float(comb_ref.abs().max())
        fault2["max_comb_err"] = max(fault2["max_comb_err"], float(err.max()))
        fault2["rows_top2_changed"] += int(changed.sum())
        fault2["max_err_same_choice"] = max(fault2["max_err_same_choice"], same)
        fault2["max_sorted_err_changed_choice"] = max(fault2["max_sorted_err_changed_choice"],
                                                      swapped)
        ok = same <= tol and swapped <= tol
        log(f"  bf16 decode step B=256 LayerNorm, moe epilogue, seed {seed}: comb max_abs_err "
            f"{float(err.max()):.3e}, rows with another top-2 {int(changed.sum())} (sorted "
            f"weights {swapped:.3e}), other rows {same:.3e} (tolerance {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"bf16 moe epilogue, seed {seed}: the combine weights disagree")
    log(f"  bf16 moe epilogue over {FAULT2_SEEDS} seeds at 256 rows: {json.dumps(fault2)}")
    for rows in (4, 64):
        h_ = randn(rows, md)
        for name, w in (("ssm_decode_step_int8_moe", m_qmixer), ("ssm_decode_step_moe", m_mixer)):
            for kind, plan in zip(("in", "mix", "out"), step_plan(h_, w)):
                decode_resources[f"{name} {kind} at {rows} rows (MoE widths)"] = dict(
                    plan._asdict(), **ssm_step_resources(kind, plan, w.quantized))
    log_resources([k for k in decode_resources if k.endswith("(MoE widths)")])
    log("int8 and bf16 decode step with the moe epilogue (#3), warm and cold weights:")
    decode.update(moe_step_times(card, moe_qmodel, moe_config, moe_model))
    log("the fat MoE FFN (#10, int8) over the 44 layers' fat stacks, warm and cold:")
    decode.update(fat_times(card, moe_qmodel, moe_config))
    fat_plan_resources(8, md, m_inter)
    for b, w, label in [(5, m_mixer, "bf16"), (5, m_qmixer, "int8")]:
        args = moe_step_inputs(b, w, m_fnorm, None)[:6]
        check_kernel("ssm_decode_step_int8" if w.quantized else "ssm_decode_step",
                     f"{label} decode step B={b} dense epilogue at the MoE mixer's shapes",
                     args, ssm_decode_step, ssm_decode_step_reference,
                     step_tols_q if w.quantized else step_tols)

    def fat_inputs(s_, ffn=mqlayer.ffn, fat_=fat, act=moe_config.hidden_act):
        """Routed rows as the MoE FFN gives them to the fat kernel."""
        x = ffn.pre_norm(randn(s_, md))
        routing = moe_ops.route(x, *ffn.router_weights(), 2, layer_norm_eps=eps)
        xq, xs = moe_ops.center_quantize(x, eps)
        comb = moe_ops._combine_weights(routing, n_exp, torch.float32)
        return (xq, xs, comb, fat_["w1t_q"], fat_["w1t_s"], fat_["b1t"], fat_["w2t_q"],
                fat_["w2t_s"], n_exp, act)

    def expert_bytes(used, *tensors):
        """Bytes of the experts' column or row blocks that the routing uses."""
        return sum(nbytes(t) * int(used.sum()) // n_exp for t in tensors)

    def fat_cost(args):
        xq, xs, comb, w1q, w1s, b1t, w2q, w2s = args[:8]
        used = (comb != 0).any(dim=0)
        inter_ = w1q.shape[1] // n_exp
        return (nbytes(xq, xs, comb, w2s) + expert_bytes(used, w1q, w1s, b1t, w2q)
                + xq.numel() * 4, 4 * int((comb != 0).sum()) * xq.shape[1] * inter_, "int8")

    fat_tols = [("out", BF16_ULP)]    # f32 out; a flipped hidden level is allowed
    args = fat_inputs(5)
    check_sensitive("expert_ffn_fat", expert_ffn_fat_reference, args, {
        "combine weights": args[:2] + ((args[2] != 0).float(),) + args[3:],
        "b1t": args[:5] + (torch.zeros_like(args[5]),) + args[6:],
        "w1t_s": args[:4] + (torch.ones_like(args[4]),) + args[5:],
        "w2t_s": args[:7] + (torch.ones_like(args[7]),) + args[8:],
    }, fat_tols)
    for s_ in (4, 5, 64, 256):
        args = fat_inputs(s_)
        check_kernel("expert_ffn_fat", f"expert_ffn_fat S={s_} (H={md}, E={n_exp}, I={m_inter}, "
                     f"bn={fat_block_n(m_inter)})", args, expert_ffn_fat,
                     expert_ffn_fat_reference, fat_tols,
                     cost=fat_cost(args) if s_ == 64 else None, repeat=s_ == 64)
    args = fat_inputs(5, ffn=mlayer.ffn, fat_=mlayer.ffn.experts.fat())
    check_kernel("expert_ffn_fat", "expert_ffn_fat S=5, the bf16 model's fat stack", args,
                 expert_ffn_fat, expert_ffn_fat_reference, fat_tols)
    i256 = 256
    small_experts = {
        "ln_w": 1 + randn(n_exp, md, dtype=torch.float32, std=0.1),
        "ln_b": randn(n_exp, md, dtype=torch.float32, std=0.1),
        "w1": randn(n_exp, md, i256, dtype=torch.float32, std=0.02),
        "b1": randn(n_exp, i256, dtype=torch.float32, std=0.1),
        "w2": randn(n_exp, i256, md, dtype=torch.float32, std=0.02)}
    fat256 = fuse_one_fat(small_experts)
    log(f"  I={i256}: bn = {fat_block_n(i256)}, {i256 // fat_block_n(i256)} tiles per expert")
    for s_ in (5, 64):
        check_kernel("expert_ffn_fat", f"expert_ffn_fat S={s_} I={i256}",
                     fat_inputs(s_, fat_=fat256), expert_ffn_fat, expert_ffn_fat_reference,
                     fat_tols)

    def grouped_inputs(s_, probs, fat_=fat):
        """Token rows routed to two distinct experts each with the given
        (uneven) probabilities, laid out by the grouped dispatch."""
        idx = torch.multinomial(probs.expand(s_, n_exp), 2, replacement=False, generator=g)
        xq, xs = moe_ops.center_quantize(mqlayer.ffn.pre_norm(randn(s_, md)), eps)
        dest, emap = moe_ops.grouped_dispatch(idx, n_exp)
        p = emap.numel() * TILE
        xq_pad = torch.zeros((p, md), dtype=torch.int8, device=dev)
        xs_pad = torch.zeros((p, 1), dtype=torch.float32, device=dev)
        xq_pad[dest] = xq.repeat_interleave(2, dim=0)
        xs_pad[dest] = xs.repeat_interleave(2, dim=0)
        return (xq_pad, xs_pad, emap, fat_["w1t_q"], fat_["w1t_s"], fat_["b1t"],
                fat_["w2t_q"], fat_["w2t_s"], n_exp, moe_config.hidden_act)

    def grouped_cost(args, rows):
        xq_pad, xs_pad, emap, w1q, w1s, b1t, w2q, w2s = args[:8]
        used = torch.zeros(n_exp, dtype=torch.bool, device=dev)
        used[emap[emap >= 0].long()] = True
        inter_ = w1q.shape[1] // n_exp
        return (nbytes(xq_pad, xs_pad, emap, w2s) + expert_bytes(used, w1q, w1s, b1t, w2q)
                + xq_pad.numel() * 2, 4 * rows * xq_pad.shape[1] * inter_, "int8")

    # Uneven loads, expert 7 empty.
    probs = torch.tensor([8.0, 4, 2, 1, 1, 1, 1, 0], device=dev)
    args = grouped_inputs(37, probs)
    check_sensitive("expert_ffn_grouped", expert_ffn_grouped_reference, args, {
        "b1t": args[:5] + (torch.zeros_like(args[5]),) + args[6:],
        "w1t_s": args[:4] + (torch.ones_like(args[4]),) + args[5:],
        "w2t_s": args[:7] + (torch.ones_like(args[7]),) + args[8:],
    }, [("out", BF16_ULP)])
    for s_, label in ((2048, "request B's 64 x 32"), (37, "ragged")):
        args = grouped_inputs(s_, probs)
        live = int((args[2] >= 0).sum())
        label = (f"expert_ffn_grouped {s_} tokens ({label}): P = {args[0].shape[0]}, {live} "
                 f"live tiles of {TILE}, expert 7 empty")
        check_kernel("expert_ffn_grouped", label, args, expert_ffn_grouped,
                     expert_ffn_grouped_reference, [("out", BF16_ULP)],
                     cost=grouped_cost(args, 2 * s_) if s_ == 2048 else None, repeat=True)
        same = torch.equal(expert_ffn_grouped(*args), expert_ffn_grouped_reference(*args))
        log(f"  {label}: bit-equal to the plain version: {same}")
    # A prefill of 33,000 tokens: P past 65,535 rows, more than a grid's y
    # dimension holds, so no launch may put a block on each row. Its draws
    # are given back, so that every later check sees the data it always had.
    g_state = g.get_state()
    args = grouped_inputs(33_000, probs)
    g.set_state(g_state)
    label = f"expert_ffn_grouped 33000 tokens: P = {args[0].shape[0]}"
    got = expert_ffn_grouped(*args)
    errs["expert_ffn_grouped"] = max(errs["expert_ffn_grouped"], compare(
        f"{label} out", got, expert_ffn_grouped_reference(*args), BF16_ULP))
    if not torch.equal(got, expert_ffn_grouped(*args)):
        raise RuntimeError(f"{label}: a second run gave other bits")
    log(f"  {label}: a second run gives the same bits ok")
    del args, got

    # ---- 3c. the 1.5B MHA model and its kernel checks -----------------------
    # bench.py's arch="mha" preset: the dense preset's widths with standard
    # MHA, text-only; attention dropout 0 gives q/k/v/o biases.
    mha_config = mha_preset_config(dims)
    t0 = time.perf_counter()
    tree = init_params(mha_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=bf16)
    mha_params = count_params(tree)
    if mha_params != 1_497_970_944:
        raise RuntimeError(f"MHA model: {mha_params:,} parameters, not 1,497,970,944")
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 5))
    mha_model = from_jax_params(tree, mha_config, device=dev, dtype=bf16)
    qtree = quantize_params(tree)
    del tree
    mha_qmodel = from_jax_params(qtree, mha_config, device=dev, dtype=bf16)
    del qtree
    torch.cuda.synchronize()
    head_dim, mha_heads = mha_config.head_dim, mha_config.num_attention_heads
    log(f"MHA model: {mha_params:,} parameters, hidden {d}, {mha_config.num_hidden_layers} "
        f"layers, {mha_heads} heads of {head_dim}, q/k/v/o biases "
        f"{mha_config.qkv_bias}, FFN {inter}, bf16 and int8, built in "
        f"{time.perf_counter() - t0:.1f} s")

    def decode_ctx_inputs(b, l, heads=mha_heads, hd=head_dim, int8=False, gen=None, prefix=0,
                          bucket=None):
        """A layer's cache as serving leaves it: row b holds an image
        prefix in slots [0, prefix), its prompt in the next len_b slots,
        bucket padding up to slot prefix + bucket (default l // 2),
        generated tokens from there to the stale slot t = l - 1, which is
        masked."""
        d_ = heads * hd
        bucket = l // 2 if bucket is None else bucket
        q, k_new, v_new = randn(b, d_, gen=gen), randn(b, d_, gen=gen), randn(b, d_, gen=gen)
        k, v = randn(b, l, d_, gen=gen), randn(b, l, d_, gen=gen)
        lens = torch.randint(1, bucket + 1, (b, 1), generator=gen or g, device=dev)
        slots = torch.arange(l, device=dev)[None, :]
        valid = (slots < prefix + lens) | ((slots >= prefix + bucket) & (slots < l - 1))
        bias = torch.where(valid, 0.0, NEG).float().contiguous()
        if not int8:
            return (q, k, v, k_new, v_new, bias, hd)
        (kq, ks), (vq, vs) = quantize_heads(k, hd), quantize_heads(v, hd)
        return (q, kq, vq, k_new, v_new, bias, ks.transpose(1, 2).contiguous(),
                vs.transpose(1, 2).contiguous(), hd)

    def decode_ctx_int8_plain(q, k, v, k_new, v_new, bias, ks, vs, hd):
        return mha_decode_ctx_reference(q, k, v, k_new, v_new, bias, hd, ks, vs)

    def decode_ctx_dropping(term, q, k, v, k_new, v_new, bias, hd, ks=None, vs=None):
        """The plain decode attention with one term left out: the self-term,
        the mask, or an int8 scale (ks, vs, qs)."""
        b, d_ = q.shape
        heads = d_ // hd
        qs = (q.float() * hd ** -0.5).to(q.dtype).float().reshape(b, heads, hd)
        kh = k.float().reshape(b, -1, heads, hd)
        if ks is None:
            s = torch.einsum("bhd,blhd->bhl", qs, kh)
        else:
            qscale = torch.clamp(qs.abs().amax(dim=-1), min=1e-8) * (1.0 / 127.0)
            q_i = torch.clamp(torch.round(qs / qscale[..., None]), -127, 127)
            s = torch.einsum("bhd,blhd->bhl", q_i, kh)
            s = s * ((1.0 if term == "ks" else ks)
                     * (1.0 if term == "qs" else qscale[..., None]))
        if term != "mask":
            s = s + bias[:, None, :]
        s_self = (qs * k_new.float().reshape(b, heads, hd)).sum(dim=-1)
        m = s.amax(dim=-1) if term == "self-term" else torch.maximum(s.amax(dim=-1), s_self)
        p = torch.exp(s - m[..., None])
        p_self = torch.zeros_like(m) if term == "self-term" else torch.exp(s_self - m)
        denom = p.sum(dim=-1) + p_self
        if vs is not None and term != "vs":
            p = p * vs
        ctx = (torch.einsum("bhl,blhd->bhd", p, v.float().reshape(b, -1, heads, hd))
               + p_self[..., None] * v_new.float().reshape(b, heads, hd))
        return (ctx / denom[..., None]).reshape(b, d_).to(q.dtype)

    def decode_ctx_cost(args):
        b, d_ = args[0].shape
        l = args[1].shape[1]
        return (nbytes(*args[:-1]) + nbytes(args[0]), 4 * b * l * d_,
                "int8" if args[1].dtype == torch.int8 else "bf16")

    library = {}
    # #7's library call on a column-major copy of the weight, beside the one
    # on the tree's row-major weight (library); no other kernel has one.
    library_cols = {}

    def sdpa_decode_ms(args):
        """#9's library yardstick on its bf16 arguments: SDPA over the cache
        with the new slot (the last) written, outside the timed region,
        under the same mask."""
        q, k, v, k_new, v_new, bias, hd = args
        b, l = bias.shape
        kc, vc = k.clone(), v.clone()
        kc[:, l - 1], vc[:, l - 1] = k_new, v_new
        heads4 = lambda z: z.reshape(b, -1, q.shape[1] // hd, hd).transpose(1, 2)   # noqa: E731
        keep = ((bias == 0) | (torch.arange(l, device=dev) == l - 1))[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = cuda_ms(lambda: sdpa(heads4(q), heads4(kc), heads4(vc), attn_mask=keep))
        log(f"  library: scaled_dot_product_attention over the written cache {ms:.4f} ms "
            f"(B={b} L={l}); card: {card}")
        return ms
    ctx_tols = [("ctx", BF16_ULP)]
    args = decode_ctx_inputs(5, 37)
    check_sensitive("mha_decode_ctx", mha_decode_ctx_reference, args, {
        term: lambda t=term: decode_ctx_dropping(t, *args) for term in ("self-term", "mask")},
        ctx_tols)
    args = decode_ctx_inputs(5, 37, int8=True)
    check_sensitive("mha_decode_ctx_int8", decode_ctx_int8_plain, args, {
        term: lambda t=term: decode_ctx_dropping(t, *args[:6], head_dim, *args[6:8])
        for term in ("self-term", "mask", "ks", "vs", "qs")}, ctx_tols)
    for b, l, heads, hd, label in [(4, 88, mha_heads, head_dim, "request A's cache"),
                                   (64, 96, mha_heads, head_dim, "request B's cache"),
                                   (64, 256, mha_heads, head_dim, "bench.py's allocation"),
                                   (4, 2048, mha_heads, head_dim, "long cache"),
                                   (5, 37, 4 * mha_heads // 2, 32, "Dh 32"),
                                   (5, 37, mha_heads // 2, 128, "Dh 128"),
                                   (5, 37, 4, 96, "Dh 96"), (5, 37, 2, 192, "Dh 192")]:
        timed = (b, l) == (64, 96)
        # Dh 96 and 192 draw from a generator of their own, so that every
        # other check sees the inputs it saw before they were added.
        gen = torch.Generator(device=dev).manual_seed(SEED + 13) if hd in (96, 192) else None
        args = decode_ctx_inputs(b, l, heads, hd, gen=gen)
        check_kernel("mha_decode_ctx", f"mha_decode_ctx B={b} L={l} {heads}x{hd} ({label})",
                     args, mha_decode_ctx, mha_decode_ctx_reference, ctx_tols,
                     cost=decode_ctx_cost(args) if timed else None)
        if timed:
            library["mha_decode_ctx"] = sdpa_decode_ms(args)
        args = decode_ctx_inputs(b, l, heads, hd, int8=True, gen=gen)
        check_kernel("mha_decode_ctx_int8", f"mha_decode_ctx_int8 B={b} L={l} {heads}x{hd} "
                     f"({label})", args, mha_decode_ctx_int8, decode_ctx_int8_plain, ctx_tols,
                     cost=decode_ctx_cost(args) if timed else None)

    flash_tols = [("out", FLASH_TOL), ("lse", LSE_TOL)]
    args = (randn(2, 4, 200, head_dim), randn(2, 4, 200, head_dim), randn(2, 4, 200, head_dim))
    check_sensitive("flash_attention_fwd", flash_attention_fwd_reference, args,
                    {"causal mask": args + (False,)}, flash_tols)
    for shape in ((4, mha_heads, 1024, head_dim), (4, mha_heads, 300, head_dim),
                  (2, mha_heads, 128, head_dim), (2, mha_heads // 2, 256, 128)):
        args = tuple(randn(*shape) for _ in range(3))
        b, h_, l, hd = shape
        timed = l == 1024
        # Causal: each of the L (L + 1) / 2 visible pairs costs 2 Dh MACs.
        cost = (4 * nbytes(args[0]) + b * h_ * l * 4, 4 * b * h_ * hd * l * (l + 1) // 2, "bf16")
        check_kernel("flash_attention_fwd", f"flash_attention_fwd {shape}", args,
                     flash_attention_fwd, flash_attention_fwd_reference, flash_tols,
                     cost=cost if timed else None)
        if timed:
            library["flash_attention_fwd"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(*args, is_causal=True))
            log(f"  library: scaled_dot_product_attention(is_causal=True) "
                f"{library['flash_attention_fwd']:.4f} ms; card: {card}")

    # ---- 3e. w4a8 serving: the w8a8 product and the int4 layouts ------------
    # quant_matmul_dyn at the shapes its callers give it: the 1.5B prefill's
    # six int8 linears of a layer (2048 rows), the int8 head at 64 and 4
    # decode rows, the MoE mixer's narrow N at ragged rows.
    qmix = qlayer.attn
    qmm_cases = [
        (2048, qmix.in_proj_x, "1.5B in_proj_x/z at 2048 rows"),
        (2048, qmix.x_param_proj, "1.5B x_param_proj at 2048 rows"),
        (2048, qmix.out_proj, "1.5B out_proj at 2048 rows"),
        (2048, q1, "1.5B FFN w1 at 2048 rows"),
        (2048, q2, "1.5B FFN w2 at 2048 rows"),
        (64, None, "int8 head at 64 rows"),
        (4, None, "int8 head at 4 rows"),
        (37, mqlayer.attn.in_proj_x, "MoE in_proj_x at 37 rows"),
        (37, mqlayer.attn.x_param_proj, "MoE x_param_proj at 37 rows"),
        (37, None, "ragged N = 44"),
        (300, mqlayer.attn.out_proj, "MoE out_proj at 300 rows"),
    ]
    head_q, head_s = quantize_weight(qmodel.embed.tok.T)
    head_q = head_q.contiguous()

    def qmm_inputs(rows, lin, label, out_dtype):
        if lin is not None:
            w_q, w_s, b = lin.w_q, lin.w_s, lin.b
        elif "head" in label:
            w_q, w_s, b = head_q, head_s, None
        else:
            w_q, w_s = quantize_weight(randn(md // 4, 44, std=0.05))
            b = randn(44, std=0.1)
        x_q, x_s = quantize_rows(randn(rows, w_q.shape[0]))
        if b is not None:
            b = b.to(out_dtype)
        return (x_q, x_s, w_q, w_s, b, out_dtype)

    def qmm_cost(args):
        x_q, x_s, w_q, w_s, b, out_dtype = args
        m_, k_ = x_q.shape
        n_ = w_q.shape[1]
        out_bytes = m_ * n_ * torch.tensor([], dtype=out_dtype).element_size()
        return (nbytes(x_q, x_s, w_q, w_s, b) + out_bytes, 2 * m_ * n_ * k_, "int8")

    qmm_tols = [("out", QMM_TOL)]
    args = qmm_inputs(37, q1, "", bf16)
    x_q, x_s, w_q, w_s, b, out_dtype = args
    check_sensitive("quant_matmul_dyn", quant_matmul_dyn_pre_q_reference, args, {
        "x_s": (x_q, torch.ones_like(x_s), w_q, w_s, b, out_dtype),
        "w_s": (x_q, x_s, w_q, torch.ones_like(w_s), b, out_dtype),
        "b": (x_q, x_s, w_q, w_s, None, out_dtype),
    }, qmm_tols, factor=SENSITIVITY_FACTOR)
    for rows, lin, label in qmm_cases:
        for out_dtype in (bf16, f32):
            args = qmm_inputs(rows, lin, label, out_dtype)
            timed = label == "1.5B FFN w1 at 2048 rows" and out_dtype == bf16
            check_kernel("quant_matmul_dyn_pre_q", f"quant_matmul_dyn {label} (K={args[2].shape[0]}, "
                         f"N={args[2].shape[1]}), {str(out_dtype)[6:]} result"
                         f"{', bias' if args[4] is not None else ''}", args,
                         quant_matmul_dyn_pre_q, quant_matmul_dyn_pre_q_reference, qmm_tols,
                         cost=qmm_cost(args) if timed else None)
            if timed:
                x_q, _, w_q = args[:3]
                library["quant_matmul_dyn_pre_q"] = cuda_ms(lambda: torch._int_mm(x_q, w_q))
                w_cols = w_q.t().contiguous().t()
                library_cols["quant_matmul_dyn_pre_q"] = cuda_ms(
                    lambda: torch._int_mm(x_q, w_cols))
                log(f"  library: torch._int_mm on the same int8 operands (the product "
                    f"alone) {library['quant_matmul_dyn_pre_q']:.4f} ms; with a column-major "
                    f"copy of the weight {library_cols['quant_matmul_dyn_pre_q']:.4f} ms; "
                    f"card: {card}")

    # The int8 ViT's products (quantize_vision=True) at request B's 64 x 197
    # image tokens: in_proj (K = 768, N = 2304), attn_out (768), linear1
    # (3072) and linear2 (K = 3072, N = 768), bit-equal, each timed.
    for k_, n_, what in ((768, 2304, "in_proj"), (768, 768, "attn_out"),
                         (768, 3072, "linear1"), (3072, 768, "linear2")):
        w_q, w_s = quantize_weight(randn(k_, n_, std=0.02))
        x_q, x_s = quantize_rows(randn(12608, k_))
        args = (x_q, x_s, w_q, w_s, randn(n_, std=0.1), bf16)
        label = f"int8 ViT {what} at 12,608 rows (K={k_}, N={n_})"
        check_kernel("quant_matmul_dyn_pre_q", f"quant_matmul_dyn {label}, bf16 result, bias",
                     args, quant_matmul_dyn_pre_q, quant_matmul_dyn_pre_q_reference, qmm_tols,
                     cost=qmm_cost(args), shape=label)

    # The decode FFN's int4 layout at the 1.5B widths, the pack built from
    # the int8 layer as the engine builds it.
    pack = int4_ffn_pack({"w_q": q1.w_q, "w_s": q1.w_s, "b": q1.b},
                         {"w_q": q2.w_q, "w_s": q2.w_s, "b": q2.b})
    int4_w = (pack["w1"]["w_q4"], pack["w1"]["w_sh"], pack["w1"]["w_s"], q1.b,
              pack["w2"]["w_q4"], pack["w2"]["w_sh"], pack["w2"]["w_s"], q2.b)
    log(f"  int4 FFN pack: {nbytes(*int4_w):,} bytes a layer (int8: "
        f"{nbytes(q1.w_q, q1.w_s, q1.b, q2.w_q, q2.w_s, q2.b):,})")

    def ffn4_inputs(s_, act=config.hidden_act):
        x_q, x_s = quantize_rows(randn(s_, d))
        return (x_q, x_s, *int4_w, act)

    args = ffn4_inputs(5)

    def ffn4_without(**terms):
        names = ("x_q", "x_s", "w1_q4", "w1_sh", "w1_s", "b1", "w2_q4", "w2_sh", "w2_s", "b2",
                 "act")
        values = dict(zip(names, args))
        values.update(terms)
        return tuple(values[n] for n in names)

    check_sensitive("int4 ffn", ffn_decode_int4_reference, args, {
        "w1_sh and w2_sh": ffn4_without(w1_sh=torch.ones_like(args[3]),
                                        w2_sh=torch.ones_like(args[7])),
        "x_s": ffn4_without(x_s=torch.ones_like(args[1])),
        "w1_s": ffn4_without(w1_s=torch.ones_like(args[4])),
        "w2_s": ffn4_without(w2_s=torch.ones_like(args[8])),
        "b1": ffn4_without(b1=torch.zeros_like(args[5])),
    }, [("out", BF16_ULP)], factor=SENSITIVITY_FACTOR)
    # At the layer's own b2 (noise of std 0.1) dropping it moves the plain
    # output by about one tolerance, above or below it as the data falls, so
    # b2's check runs on the same x with b2 scaled by B2_SENSITIVITY_SCALE in
    # the base and zero in the variant: no draw from the generator, so every
    # later check keeps its data. The kernel is held to its plain version on
    # that base too, so the comparison the check covers runs.
    b2_label = f"b2 (at {B2_SENSITIVITY_SCALE} x the layer's)"
    b2_base = ffn4_without(b2=B2_SENSITIVITY_SCALE * args[9])
    check_sensitive("int4 ffn", ffn_decode_int4_reference, b2_base, {
        b2_label: ffn4_without(b2=torch.zeros_like(args[9])),
    }, [("out", BF16_ULP)], factor=SENSITIVITY_FACTOR)
    check_kernel("ffn_decode_int4", f"int4 ffn S=5, {b2_label}", b2_base, ffn_decode_int4,
                 ffn_decode_int4_reference, [("out", BF16_ULP)])
    # And the int4 layout at I = 1536, packed from phase 3's int8 weights.
    pack2 = int4_ffn_pack({"w_q": wq1, "w_s": ws1, "b": b1_2}, {"w_q": wq2, "w_s": ws2, "b": b2_2})
    int4_w2 = (pack2["w1"]["w_q4"], pack2["w1"]["w_sh"], pack2["w1"]["w_s"], b1_2,
               pack2["w2"]["w_q4"], pack2["w2"]["w_sh"], pack2["w2"]["w_s"], b2_2)
    pack3 = int4_ffn_pack({"w_q": wq1_3, "w_s": ws1_3, "b": b1_3},
                          {"w_q": wq2_3, "w_s": ws2_3, "b": b2_3})
    int4_w3 = (pack3["w1"]["w_q4"], pack3["w1"]["w_sh"], pack3["w1"]["w_s"], b1_3,
               pack3["w2"]["w_q4"], pack3["w2"]["w_sh"], pack3["w2"]["w_s"], b2_3)
    for weights, i_, cases in ((int4_w, inter, ffn_cases), (int4_w2, inter2, ffn_cases),
                               (int4_w3, inter3, [(4, config.hidden_act),
                                                  (64, config.hidden_act)])):
        for s_, act in cases:
            x_q, x_s = quantize_rows(randn(s_, d))
            args = (x_q, x_s, *weights, act)
            check_kernel("ffn_decode_int4", f"int4 ffn S={s_} {act} (D={d}, I={i_}, "
                         f"bn={pick_block_n(i_)})", args, ffn_decode_int4,
                         ffn_decode_int4_reference, [("out", BF16_ULP)],
                         cost=(nbytes(*args[:10]) + s_ * d * 2, 4 * s_ * d * i_, "int8")
                         if (s_, act, i_) == (64, config.hidden_act, inter) else None,
                         repeat=True)

    # The 3B MoE preset: the largest factory MoE preset whose H and I are
    # multiples of 128, so its fat stacks pack to int4.
    m3dims = calculate_model_dimensions("3B", 32000, use_expert_system=True)
    moe3_config = dataclasses.replace(
        moe_config, hidden_size=m3dims["hidden_size"],
        num_hidden_layers=m3dims["num_hidden_layers"],
        num_attention_heads=m3dims["num_attention_heads"],
        intermediate_size=m3dims["intermediate_size"])
    t0 = time.perf_counter()
    tree = init_params(moe3_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=bf16)
    moe3_params = count_params(tree)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 10))
    qtree = quantize_params(tree)
    del tree
    moe3_model = from_jax_params(qtree, moe3_config, device=dev, dtype=bf16)
    del qtree
    moe3_model.attach_moe_fat(bits=4)
    torch.cuda.synchronize()
    h3, i3 = moe3_config.hidden_size, moe3_config.intermediate_size
    m3layer = moe3_model.layers[0]
    fat3 = m3layer.ffn.experts.fat()
    if "w1t_q4" not in fat3:
        raise RuntimeError("3B MoE: the fat stack was not packed to int4")
    log(f"3B MoE model: {moe3_params:,} parameters in the tree ({m3dims['calculated_params']:,} "
        f"by the factory's count), hidden {h3}, {moe3_config.num_hidden_layers} layers, "
        f"{moe3_config.num_attention_heads} heads, d_inner {moe3_config.ssm_d_inner}, "
        f"{n_exp} experts of {i3} (top-2), int8 with int4 fat stacks "
        f"({nbytes(*fat3.values()):,} bytes a layer, bn = {fat_block_n(i3)}), built in "
        f"{time.perf_counter() - t0:.1f} s")

    def fat4_inputs(s_, act=moe3_config.hidden_act):
        ffn = m3layer.ffn
        x = ffn.pre_norm(randn(s_, h3))
        routing = moe_ops.route(x, *ffn.router_weights(), 2, layer_norm_eps=eps)
        xq, xs = moe_ops.center_quantize(x, eps)
        comb = moe_ops._combine_weights(routing, n_exp, torch.float32)
        return (xq, xs, comb, fat3["w1t_q4"], fat3["w1t_sh"], fat3["w1t_s"], fat3["b1t"],
                fat3["w2t_q4"], fat3["w2t_sh"], fat3["w2t_s"], n_exp, act)

    def fat4_cost(args):
        xq, xs, comb, w1q, w1sh, w1s, b1t, w2q, w2sh, w2s = args[:10]
        used = (comb != 0).any(dim=0)
        return (nbytes(xq, xs, comb, w2s) + expert_bytes(used, w1q, w1sh, w1s, b1t, w2q, w2sh)
                + xq.numel() * 4, 4 * int((comb != 0).sum()) * xq.shape[1] * i3, "int8")

    args = fat4_inputs(5)

    def fat4_without(index, value):
        return args[:index] + (value,) + args[index + 1:]

    check_sensitive("expert_ffn_fat_int4", expert_ffn_fat_int4_reference, args, {
        "combine weights": fat4_without(2, (args[2] != 0).float()),
        "w1t_sh": fat4_without(4, torch.ones_like(args[4])),
        "w1t_s": fat4_without(5, torch.ones_like(args[5])),
        "b1t": fat4_without(6, torch.zeros_like(args[6])),
        "w2t_sh": fat4_without(8, torch.ones_like(args[8])),
        "w2t_s": fat4_without(9, torch.ones_like(args[9])),
    }, fat_tols, factor=SENSITIVITY_FACTOR)
    for s_ in (4, 64, 256, 5):
        args = fat4_inputs(s_)
        check_kernel("expert_ffn_fat_int4", f"expert_ffn_fat_int4 S={s_} (H={h3}, E={n_exp}, "
                     f"I={i3}, bn={fat_block_n(i3)})", args, expert_ffn_fat_int4,
                     expert_ffn_fat_int4_reference, fat_tols,
                     cost=fat4_cost(args) if s_ == 64 else None, repeat=s_ == 64)
    log(f"the fat MoE FFN (#10, int4) over {COLD_INT4_LAYERS} of the 3B model's int4 fat "
        "stacks, warm and cold:")
    decode.update(fat_times(card, moe3_model, moe3_config, layers=COLD_INT4_LAYERS))
    fat_plan_resources(4, h3, i3)

    # ---- 3f. the selectable int8 arithmetic: #6, #8 and #11 -----------------
    # quant_matmul (#6, quant_matmul="pallas") and quant_matmul_dyn_fused (#8,
    # "fused") at the 1.5B FFN's w1 at 64 decode and 2048 prefill rows, the
    # int8 head at 4 rows (N = 32000), x_param_proj at 300 rows (K = 608: the
    # second 512-wide block of #8 is partial), N = 44 at 17 rows and K = 597
    # (rows not a whole number of 16-byte loads), in bf16 and f32; #8 also
    # at 16 and 128 rows and on w2 (K = 9728) at 4, 17 and 64 rows, where its
    # plan splits K over a cluster on whole 512-wide blocks;
    # expert_ffn_dense (#11, moe_mode="kernel") at the 1.5B MoE
    # widths with the int8 and the bf16 model's per-expert stacks.
    qmm_f32_tol = [("out", QMM_F32_TOL)]
    qmm_bf16_tol = [("out", BF16_ULP)]
    w44_q, w44_s = quantize_weight(randn(608, 44, std=0.05))
    b44 = randn(44, std=0.1)
    w597_q, w597_s = quantize_weight(randn(597, 44, std=0.05))
    mode_cases = [
        (64, (q1.w_q, q1.w_s, q1.b), "1.5B FFN w1 at 64 rows"),
        (2048, (q1.w_q, q1.w_s, q1.b), "1.5B FFN w1 at 2048 rows"),
        (4, (head_q, head_s, None), "int8 head at 4 rows"),
        (300, (qmix.x_param_proj.w_q, qmix.x_param_proj.w_s, None),
         "1.5B x_param_proj at 300 rows"),
        (17, (w44_q, w44_s, b44), "ragged N = 44"),
        (17, (w597_q, w597_s, b44), "ragged K = 597, N = 44"),
    ]

    def mode_inputs(rows, weights, dtype, std=1.0):
        w_q, w_s, b = weights
        return (randn(rows, w_q.shape[0], dtype=dtype, std=std), w_q, w_s,
                None if b is None else b.to(dtype))

    def mode_cost(args, kind):
        x, w_q, w_s, b = args
        m_, k_ = x.shape
        n_ = w_q.shape[1]
        return (nbytes(x, w_q, w_s, b) + m_ * n_ * x.element_size(), 2 * m_ * n_ * k_, kind)

    args = mode_inputs(37, (q1.w_q, q1.w_s, q1.b), bf16, std=0.1)
    check_sensitive("quant_matmul", quant_matmul_reference, args, {
        "w_s": args[:2] + (torch.ones_like(args[2]), args[3]),
        "b": args[:3] + (None,),
    }, qmm_bf16_tol, factor=SENSITIVITY_FACTOR)
    check_sensitive("quant_matmul_dyn_fused", quant_matmul_dyn_fused_reference, args, {
        "w_s": args[:2] + (torch.ones_like(args[2]), args[3]),
        "b": args[:3] + (None,),
        "per-block scales (one scale a row, #7's arithmetic)": lambda: (
            quant_matmul_dyn_pre_q_reference(*quantize_rows(args[0]), *args[1:], bf16),),
    }, qmm_tols, factor=SENSITIVITY_FACTOR)
    for rows, weights, label in mode_cases:
        for dtype in (bf16, f32):
            args = mode_inputs(rows, weights, dtype)
            shape = f"(K={args[1].shape[0]}, N={args[1].shape[1]}), {str(dtype)[6:]}"
            timed = rows in (64, 2048) and dtype == bf16
            check_kernel("quant_matmul", f"quant_matmul {label} {shape}", args, quant_matmul,
                         quant_matmul_reference, qmm_bf16_tol if dtype == bf16 else qmm_f32_tol,
                         cost=mode_cost(args, "bf16") if timed else None)
            if timed and rows == 2048:
                w_deq = (args[1].to(bf16) * args[2].to(bf16)).contiguous()
                x_ = args[0]
                library["quant_matmul"] = cuda_ms(lambda: x_ @ w_deq)
                log(f"  library: x @ w_deq, the weight dequantized to bf16 ahead of the call "
                    f"(the product alone) {library['quant_matmul']:.4f} ms; card: {card}")
            check_kernel("quant_matmul_dyn_fused", f"quant_matmul_dyn_fused {label} {shape}",
                         args, quant_matmul_dyn_fused, quant_matmul_dyn_fused_reference,
                         qmm_tols, cost=mode_cost(args, "int8") if timed else None,
                         repeat=timed and rows == 2048)

    fused_cases = [
        (16, (q1.w_q, q1.w_s, q1.b), "1.5B FFN w1 at 16 rows"),
        (128, (qmix.x_param_proj.w_q, qmix.x_param_proj.w_s, None),
         "1.5B x_param_proj at 128 rows"),
        (128, (w44_q, w44_s, b44), "N = 44 at 128 rows"),
        (4, (q2.w_q, q2.w_s, q2.b), "1.5B FFN w2 at 4 rows"),
        (17, (q2.w_q, q2.w_s, q2.b), "1.5B FFN w2 at 17 rows"),
        (64, (q2.w_q, q2.w_s, q2.b), "1.5B FFN w2 at 64 rows"),
    ]
    for rows, weights, label in fused_cases:
        for dtype in (bf16, f32):
            args = mode_inputs(rows, weights, dtype)
            fp = fused_plan_on(args[0], args[1])
            check_kernel("quant_matmul_dyn_fused",
                         f"quant_matmul_dyn_fused {label} (K={args[1].shape[0]}, "
                         f"N={args[1].shape[1]}), {str(dtype)[6:]}, plan rows {fp.rows} split "
                         f"{fp.split} group {fp.group}", args, quant_matmul_dyn_fused,
                         quant_matmul_dyn_fused_reference, qmm_tols,
                         repeat=rows == 64 and dtype == bf16)
    fused_plans = {}
    for rows, (w_q, _, _), _ in mode_cases + fused_cases:
        fp = fused_plan_on(torch.empty((rows, w_q.shape[0]), device=dev), w_q)
        fused_plans[f"rows {fp.rows} split {fp.split}"] = fp
    for key, fp in fused_plans.items():
        for launch, res in quant_matmul_fused_resources(fp).items():
            log(f"  resources of quant_matmul_dyn_fused {launch} at plan {key} (group "
                f"{fp.group}, stages {fp.stages}): {res['registers']} registers a thread, "
                f"{res['shared_bytes']} bytes of shared memory and {res['threads']} threads a "
                f"block, {res['blocks_per_sm']} block(s) an SM, {res['spill_bytes']} bytes "
                "spilled")

    # #7 and #6 (bf16 x) alone: every tile plan against the plain versions,
    # a second run bit for bit, the resources of each plan, and the times at
    # the decode shapes beside their bytes bounds.
    log("int8-weight GEMMs #7 and #6 alone (seeded operands at the models' shapes):")
    qmm = qmm_phase(card)

    m_fused = mqlayer.ffn.experts.fused()
    log(f"MoE per-expert stack: {nbytes(*m_fused.values()):,} bytes a layer")

    def dense_inputs(s_, stack=m_fused, ffn=mqlayer.ffn, act=moe_config.hidden_act,
                     out_dtype=bf16):
        """Rows as moe_dense_fused gives them to the per-expert kernel."""
        xq, xs = moe_ops.center_quantize(ffn.pre_norm(randn(s_, md)), eps)
        return (xq, xs, stack["w1f_q"], stack["w1f_s"], stack["b1f"], stack["w2f_q"],
                stack["w2f_s"], ffn.experts.b2.float(), out_dtype, act)

    def dense_cost(args):
        xq = args[0]
        s_, h_ = xq.shape
        e_, _, i_ = args[2].shape
        return (nbytes(*args[:8]) + e_ * s_ * h_ * args[8].itemsize, 4 * e_ * s_ * h_ * i_,
                "int8")

    args = dense_inputs(5)
    # Biases with more noise than the model's, so that a dropped one moves
    # the output by 9 tolerances.
    args = args[:4] + (args[4] + randn(*args[4].shape, dtype=f32, std=0.5),) + args[5:7] + (
        args[7] + randn(*args[7].shape, dtype=f32, std=0.5),) + args[8:]

    def dense_without(index, value):
        return args[:index] + (value,) + args[index + 1:]

    check_sensitive("expert_ffn_dense", expert_ffn_dense_reference, args, {
        "xs": dense_without(1, torch.ones_like(args[1])),
        "w1s": dense_without(3, torch.ones_like(args[3])),
        "b1": dense_without(4, torch.zeros_like(args[4])),
        "w2s": dense_without(6, torch.ones_like(args[6])),
        "b2": dense_without(7, torch.zeros_like(args[7])),
    }, fat_tols, factor=SENSITIVITY_FACTOR)
    # At 4, 5, 64 and 256 rows (GEMM2's row tiles of 16 and 64, one and four
    # of them), in bf16 and f32 out and with each activation; twice at 64
    # and 256 rows for the same bits.
    for s_, out_dtype, act in ((4, bf16, moe_config.hidden_act), (64, bf16, moe_config.hidden_act),
                               (256, bf16, moe_config.hidden_act),
                               (64, f32, moe_config.hidden_act), (5, bf16, "relu"),
                               (5, bf16, "silu"), (4, f32, "relu"), (256, f32, "silu")):
        args = dense_inputs(s_, act=act, out_dtype=out_dtype)
        check_kernel("expert_ffn_dense", f"expert_ffn_dense S={s_} {act} (H={md}, E={n_exp}, "
                     f"I={m_inter}), {str(out_dtype)[6:]} out", args, expert_ffn_dense,
                     expert_ffn_dense_reference, fat_tols,
                     cost=dense_cost(args) if s_ == 64 and out_dtype == bf16 else None,
                     repeat=s_ in (64, 256))
    args = dense_inputs(5, stack=mlayer.ffn.experts.fused(), ffn=mlayer.ffn)
    check_kernel("expert_ffn_dense", "expert_ffn_dense S=5, the bf16 model's per-expert stack",
                 args, expert_ffn_dense, expert_ffn_dense_reference, fat_tols)

    # ---- 3d. the backward kernels of training ------------------------------
    ssm_heads = config.num_attention_heads     # ``heads`` was reused by the loops above

    # The forward's states (want_h), which training saves for the backward:
    # at the 1.5B training shape (no mask, as the trainer runs it) and ragged
    # with a mask; then, from a generator of their own (the later checks keep
    # their data), at the MoE mixer's training shape (11 heads) and at an L
    # that is not a multiple of FWD_CHUNK. Each over chunks of the time axis
    # (two launches), and twice for the same bits; the report lists the two
    # training shapes' times beside the prefill's.
    scan_h_tols = [("y", BF16_ULP), ("h_last", SCAN_F32_TOL), ("hs", SCAN_F32_TOL)]
    g_fwd = torch.Generator(device=dev).manual_seed(SEED + 29)
    for (b, l), masked, a_log, gen in (
            ((4, 1024), False, None, None), ((3, 300), True, None, None),
            ((4, 1024), False, mlayer.attn.A_log, g_fwd),
            ((3, 5 * FWD_CHUNK + 11), True, None, g_fwd)):
        args = scan_inputs(b, l, a_log=a_log, gen=gen)
        args = args[:4] + ((args[4] if masked else None), bf16, True)
        check_kernel("selective_scan_fwd", f"scan B={b} L={l} H={args[1].shape[0]} with every "
                     f"state (want_h){', masked' if masked else ''}, chunks of {FWD_CHUNK}",
                     args, selective_scan_fwd, selective_scan_fwd_reference, scan_h_tols,
                     repeat=True, cost=None if masked else scan_cost(args),
                     shape=f"{tuple(args[2].shape)} with every state, chunks of {FWD_CHUNK}")

    def scan_bwd_inputs(b, l, heads_=ssm_heads, dtype=bf16, masked=False, with_g_last=False,
                        n_=n, gen=None):
        """The scan's backward operands as training gives them (the forward
        kernel's f32 states and a cotangent of y in its dtype), and the plain
        forward's states for the plain side; at a d_state ``n_`` other than
        the model's, A is drawn from the init's range (A_log ~ U(log 0.5,
        log 0.99))."""
        delta = torch.nn.functional.softplus(randn(b, l, heads_, dtype=f32, gen=gen) - 4.0)
        if n_ == n:
            a_cont = -torch.exp(layer.attn.A_log.float()[:heads_])
        else:
            a_cont = -torch.empty((heads_, n_), device=dev).uniform_(0.5, 0.99,
                                                                     generator=gen or g)
        bt = randn(b, l, heads_, n_, dtype=dtype, gen=gen)
        ct = randn(b, l, heads_, n_, dtype=dtype, gen=gen)
        mask = None
        if masked:
            lens = torch.randint(1, l + 1, (b, 1), generator=gen or g, device=dev)
            mask = (torch.arange(l, device=dev)[None, :] < lens).to(torch.int32)
        hs = selective_scan_fwd(delta, a_cont, bt, ct, mask, dtype, want_h=True)[2]
        hs_plain = selective_scan_fwd_reference(delta, a_cont, bt, ct, mask, dtype, want_h=True)[2]
        g_last = randn(b, heads_, n_, dtype=f32, gen=gen) if with_g_last else None
        return ((delta, a_cont, ct, mask, hs, randn(b, l, heads_ * n_, dtype=dtype, gen=gen),
                 g_last), hs_plain)

    def plain_scan_bwd(hs_plain):
        """The plain backward on the plain forward's states."""
        return lambda delta, a_cont, ct, mask, _hs, gy, g_last: selective_scan_bwd_reference(
            delta, a_cont, ct, mask, hs_plain, gy, g_last)

    def scan_bwd_cost(args):
        delta, a_cont, ct, mask, hs, gy, g_last = args
        outs = nbytes(delta, a_cont) + 2 * nbytes(ct)      # d_delta, dA, dB, dC
        return nbytes(*(t for t in args if t is not None)) + outs, 12 * ct.numel(), "f32"

    def scan_bwd_without(term, delta, a_cont, ct, mask, hs, gy, g_last):
        """The plain scan backward with one chain factor left out: d_delta
        without a * A, or dA without a * delta (da = dB * h[t-1])."""
        d_delta, d_a, db, dc = selective_scan_bwd_reference(delta, a_cont, ct, mask, hs, gy,
                                                            g_last)
        h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
        da = db.float() * h_prev
        if term == "a*A":
            return da.sum(dim=-1), d_a, db, dc
        return d_delta, da.sum(dim=(0, 1)), db, dc

    def scan_bwd_tols(dtype):
        t = BF16_ULP if dtype == bf16 else SCAN_BWD_TOL
        return [("d_delta", SCAN_BWD_TOL), ("dA", SCAN_BWD_TOL), ("dB", t), ("dC", t)]

    args, hs_plain = scan_bwd_inputs(3, 300, masked=True, with_g_last=True)
    args = args[:4] + (hs_plain,) + args[5:]
    check_sensitive("selective_scan_bwd", selective_scan_bwd_reference, args, {
        "h_last cotangent": args[:6] + (None,),
        "mask": args[:3] + (None,) + args[4:],
        "a*A chain factor": lambda: scan_bwd_without("a*A", *args),
        "a*delta chain factor": lambda: scan_bwd_without("a*delta", *args),
    }, scan_bwd_tols(bf16))
    for (b, l), hh, dtype, masked, glast, label in [
            ((4, 1024), ssm_heads, bf16, False, False, "the 1.5B training shape"),
            ((4, 1024), ssm_heads, bf16, False, True, "with an h_last cotangent"),
            ((3, 300), ssm_heads, bf16, True, True, "ragged, masked"),
            ((3, 300), ssm_heads, f32, True, True, "f32 operands, masked"),
            ((2, 77), mlayer.attn.A_log.shape[0], bf16, False, True, "the MoE mixer's 11 heads")]:
        args, hs_plain = scan_bwd_inputs(b, l, hh, dtype, masked, glast)
        timed = label == "the 1.5B training shape"
        check_kernel("selective_scan_bwd", f"scan backward B={b} L={l} H={hh} ({label}), "
                     f"chunks of {BWD_CHUNK}", args, selective_scan_bwd,
                     plain_scan_bwd(hs_plain), scan_bwd_tols(dtype),
                     cost=scan_bwd_cost(args) if timed else None, repeat=timed or masked)

    def flash_bwd_inputs(shape):
        q, k, v, do = (randn(*shape) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v)
        return (q, k, v, do, lse, (out.float() * do.float()).sum(dim=-1))

    def flash_bwd_cost(args, outputs, products, kind="bf16"):
        b, h_, l, hd = args[0].shape
        pairs = b * h_ * l * (l + 1) // 2
        return (nbytes(*args) + outputs * nbytes(args[0]), products * 2 * hd * pairs, kind)

    args = flash_bwd_inputs((2, 4, 200, head_dim))
    for name, plain, tols in (
            ("flash_attention_dq", flash_attention_dq_reference, [("dq", FLASH_BWD_TOL)]),
            ("flash_attention_dkv", flash_attention_dkv_reference,
             [("dk", FLASH_BWD_TOL), ("dv", FLASH_BWD_TOL)])):
        check_sensitive(name, plain, args, {
            "delta": args[:5] + (torch.zeros_like(args[5]),),
            "lse": args[:4] + (torch.zeros_like(args[4]),) + args[5:],
            "causal mask": args + (False,)}, tols)
    for shape in ((4, mha_heads, 1024, head_dim), (4, mha_heads, 300, head_dim),
                  (2, mha_heads // 2, 256, 128), (2, 8, 130, 32), (1, 4, 200, 256)):
        args = flash_bwd_inputs(shape)
        timed = shape[2] == 1024
        check_kernel("flash_attention_dq", f"flash_attention_dq {shape}", args, flash_attention_dq,
                     flash_attention_dq_reference, [("dq", FLASH_BWD_TOL)],
                     cost=flash_bwd_cost(args, 1, 3) if timed else None)
        check_kernel("flash_attention_dkv", f"flash_attention_dkv {shape}", args,
                     flash_attention_dkv, flash_attention_dkv_reference,
                     [("dk", FLASH_BWD_TOL), ("dv", FLASH_BWD_TOL)],
                     cost=flash_bwd_cost(args, 2, 4) if timed else None)
        if timed:
            # The yardstick: SDPA's backward alone (its graph kept), which
            # computes dQ, dK and dV in one call, on the same inputs.
            leaves = [t.detach().requires_grad_(True) for t in args[:3]]
            out_l = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
            # Three windows, the least kept: a single window has read 3x the
            # others on the card.
            windows = [cuda_ms(lambda: torch.autograd.grad(out_l, leaves, args[3],
                                                           retain_graph=True))
                       for _ in range(3)]
            sdpa_bwd = min(windows)
            library["flash_attention_dq"] = library["flash_attention_dkv"] = sdpa_bwd
            log(f"  library: the backward of scaled_dot_product_attention(is_causal=True) "
                f"(dQ, dK and dV) {sdpa_bwd:.4f} ms (windows "
                f"{', '.join(f'{w:.4f}' for w in windows)}); card: {card}")
            del leaves, out_l

    def repeats(label, fn, args):
        """A kernel with no atomics gives the same bits on a second run."""
        a, b_ = fn(*args), fn(*args)
        a, b_ = (a if isinstance(a, tuple) else (a,)), (b_ if isinstance(b_, tuple) else (b_,))
        if not all(torch.equal(x, y) for x, y in zip(a, b_)):
            raise RuntimeError(f"{label}: a second run gave other bits")
        log(f"  {label}: a second run gives the same bits ok")

    # The bf16 flash kernels have no atomics either: the timed shape and a
    # ragged one repeat bit for bit. Then what the card gives each of them
    # (registers, shared memory, resident blocks per SM) at Dh 64, 128, 256.
    for shape in ((4, mha_heads, 1024, head_dim), (4, mha_heads, 300, head_dim)):
        repeats(f"flash_attention_fwd {shape}", flash_attention_fwd,
                tuple(randn(*shape) for _ in range(3)))
        args = flash_bwd_inputs(shape)
        repeats(f"flash_attention_dq {shape}", flash_attention_dq, args)
        repeats(f"flash_attention_dkv {shape}", flash_attention_dkv, args)
    flash_resources = {f"{kern} Dh={hd}": flash_attention_resources(kern, hd)
                       for kern in BF16_KERNELS for hd in (head_dim, 128, 256)}
    for key, res in flash_resources.items():
        log(f"  resources of the bf16 flash {key}: {res['registers']} registers a thread, "
            f"{res['shared_bytes']} bytes of shared memory and {res['threads']} threads a "
            f"block, {res['blocks_per_sm']} block(s) an SM, {res['spill_bytes']} bytes spilled")

    # The scan's backward at a d_state that is not a power of two up to 32:
    # the shared-memory head sum, at the 1.5B training shape, masked and with
    # an h_last cotangent (N = 12 last: the shape the report keeps).
    args, hs_plain = scan_bwd_inputs(3, 300, masked=True, with_g_last=True, n_=12)
    args = args[:4] + (hs_plain,) + args[5:]
    check_sensitive("selective_scan_bwd_smem", selective_scan_bwd_reference, args, {
        "h_last cotangent": args[:6] + (None,),
        "mask": args[:3] + (None,) + args[4:],
        "a*A chain factor": lambda: scan_bwd_without("a*A", *args),
        "a*delta chain factor": lambda: scan_bwd_without("a*delta", *args),
    }, scan_bwd_tols(bf16))
    for n_ in (24, 48, 64, 12):
        args, hs_plain = scan_bwd_inputs(4, 1024, masked=True, with_g_last=True, n_=n_)
        check_kernel("selective_scan_bwd_smem", f"scan backward B=4 L=1024 H={ssm_heads} N={n_} "
                     f"(masked, h_last cotangent), chunks of {BWD_CHUNK}", args,
                     selective_scan_bwd_smem, plain_scan_bwd(hs_plain), scan_bwd_tols(bf16),
                     cost=scan_bwd_cost(args))
    repeats("selective_scan_bwd_smem N=12", selective_scan_bwd_smem, args)
    args, hs_plain = scan_bwd_inputs(3, 300, dtype=f32, masked=True, with_g_last=True, n_=48)
    check_kernel("selective_scan_bwd_smem", "scan backward B=3 L=300 N=48 (f32 operands, "
                 "masked)", args, selective_scan_bwd_smem, plain_scan_bwd(hs_plain),
                 scan_bwd_tols(f32))

    # The f32 flash kernels (f32 q/k/v, split-TF32 products on the tensor
    # cores), beside scaled_dot_product_attention on the same f32 inputs
    # (TF32 off): the training shape, a ragged L, every padded head width
    # (Dh 8 and 96 fill a 32-column swizzle block in part), and non-causal
    # runs at L = 300.
    f32_flash_tols = [("out", F32_FLASH_TOL), ("lse", F32_FLASH_TOL)]
    args = tuple(randn(2, 4, 200, head_dim, dtype=f32) for _ in range(3))
    check_sensitive("flash_attention_fwd_f32", flash_attention_fwd_reference, args,
                    {"causal mask": args + (False,)}, f32_flash_tols)

    def flash_bwd_inputs_f32(shape, causal=True):
        q, k, v, do = (randn(*shape, dtype=f32) for _ in range(4))
        out, lse = flash_attention_fwd_f32(q, k, v, causal)
        return (q, k, v, do, lse, (out * do).sum(dim=-1), causal)

    args = flash_bwd_inputs_f32((2, 4, 200, head_dim))[:6]
    for name, plain, tols in (
            ("flash_attention_dq_f32", flash_attention_dq_reference, [("dq", F32_FLASH_TOL)]),
            ("flash_attention_dkv_f32", flash_attention_dkv_reference,
             [("dk", F32_FLASH_TOL), ("dv", F32_FLASH_TOL)])):
        check_sensitive(name, plain, args, {
            "delta": args[:5] + (torch.zeros_like(args[5]),),
            "lse": args[:4] + (torch.zeros_like(args[4]),) + args[5:],
            "causal mask": args + (False,)}, tols)
    for shape, causal in (((4, mha_heads, 1024, head_dim), True),
                          ((4, mha_heads, 300, head_dim), True), ((2, 8, 130, 32), True),
                          ((2, mha_heads // 2, 256, 128), True), ((1, 4, 200, 256), True),
                          ((2, 4, 200, 8), True), ((2, 4, 200, 96), True),
                          ((4, mha_heads, 300, head_dim), False), ((1, 4, 300, 256), False)):
        b, h_, l, hd = shape
        timed = l == 1024
        label = f"{shape}" + ("" if causal else " non-causal")
        args = tuple(randn(*shape, dtype=f32) for _ in range(3)) + (causal,)
        check_kernel("flash_attention_fwd_f32", f"flash_attention_fwd_f32 {label}", args,
                     flash_attention_fwd_f32, flash_attention_fwd_reference, f32_flash_tols,
                     cost=f32_flash_cost(shape, 2) if timed else None)
        bargs = flash_bwd_inputs_f32(shape, causal)
        check_kernel("flash_attention_dq_f32", f"flash_attention_dq_f32 {label}", bargs,
                     flash_attention_dq_f32, flash_attention_dq_reference,
                     [("dq", F32_FLASH_TOL)], cost=f32_flash_cost(shape, 3) if timed else None)
        check_kernel("flash_attention_dkv_f32", f"flash_attention_dkv_f32 {label}", bargs,
                     flash_attention_dkv_f32, flash_attention_dkv_reference,
                     [("dk", F32_FLASH_TOL), ("dv", F32_FLASH_TOL)],
                     cost=f32_flash_cost(shape, 4) if timed else None)
        if timed:
            library["flash_attention_fwd_f32"], sdpa_bwd = sdpa_f32_ms(args[:3], bargs[3])
            library["flash_attention_dq_f32"] = library["flash_attention_dkv_f32"] = sdpa_bwd
            log(f"  library: scaled_dot_product_attention(is_causal=True) on the f32 inputs "
                f"(TF32 off) {library['flash_attention_fwd_f32']:.4f} ms, its backward "
                f"{library['flash_attention_dq_f32']:.4f} ms; card: {card}")
        if timed or not causal:
            for name_, fn, a_ in (("flash_attention_fwd_f32", flash_attention_fwd_f32, args),
                                  ("flash_attention_dq_f32", flash_attention_dq_f32, bargs),
                                  ("flash_attention_dkv_f32", flash_attention_dkv_f32, bargs)):
                repeats(f"{name_} {label}", fn, a_)
    for kern in F32_KERNELS:
        for hd in (32, head_dim, 128, 256):
            flash_resources[f"{kern} Dh={hd}"] = res = flash_attention_resources(kern, hd)
            log(f"  resources of the f32 flash {kern} Dh={hd}: {res['registers']} registers a "
                f"thread, {res['shared_bytes']} bytes of shared memory and {res['threads']} "
                f"threads a block, {res['blocks_per_sm']} block(s) an SM, {res['spill_bytes']} "
                "bytes spilled")

    # ---- 3h. the image prefix's shapes: #9, #13 and #1 ---------------------------
    # Phase 4's MHA + ViT requests decode over caches of 197 + 67 + 24 = 288
    # slots (request A, 4 rows) and 197 + 35 + 64 = 296 (request B, 64 rows),
    # the prefix valid in the first 197; phase 6's multimodal training puts
    # 197 image tokens before 512 text tokens: L = 709, a ragged tail of the
    # flash kernels' 64-row tiles and of the scans' chunks. From a generator
    # of their own, so that every other check sees the inputs it saw before.
    g_img = torch.Generator(device=dev).manual_seed(SEED + 70)
    for b, bucket, new, label in ((4, 67, 24, "request A's cache behind the image prefix"),
                                  (64, 35, 64, "request B's cache behind the image prefix")):
        l = MM_PREFIX + bucket + new
        for name, kernel, plain, int8 in (
                ("mha_decode_ctx", mha_decode_ctx, mha_decode_ctx_reference, False),
                ("mha_decode_ctx_int8", mha_decode_ctx_int8, decode_ctx_int8_plain, True)):
            args = decode_ctx_inputs(b, l, int8=int8, gen=g_img, prefix=MM_PREFIX, bucket=bucket)
            check_kernel(name, f"{name} B={b} L={l} {mha_heads}x{head_dim} ({label})", args,
                         kernel, plain, ctx_tols, cost=decode_ctx_cost(args),
                         shape=f"B={b} L={l} ({label})")
            if not int8:
                shape_times[name][f"B={b} L={l} ({label})"]["library_ms"] = sdpa_decode_ms(args)
    shape = (4, mha_heads, MM_PREFIX + 512, head_dim)
    label = f"{shape} (multimodal training: 197 image + 512 text tokens)"
    b, h_, l, hd = shape
    for dt, fwd, dq, dkv, tols, bwd_tol in (
            (bf16, flash_attention_fwd, flash_attention_dq, flash_attention_dkv, flash_tols,
             FLASH_BWD_TOL),
            (f32, flash_attention_fwd_f32, flash_attention_dq_f32, flash_attention_dkv_f32,
             f32_flash_tols, F32_FLASH_TOL)):
        q, k, v, do = (randn(*shape, dtype=dt, gen=g_img) for _ in range(4))
        args = (q, k, v) if dt == bf16 else (q, k, v, True)
        fwd_cost = ((4 * nbytes(q) + b * h_ * l * 4, 4 * b * h_ * hd * l * (l + 1) // 2, "bf16")
                    if dt == bf16 else f32_flash_cost(shape, 2))
        check_kernel(fwd.__name__, f"{fwd.__name__} {label}", args, fwd,
                     flash_attention_fwd_reference, tols, cost=fwd_cost, shape=label)
        out, lse = fwd(*args)
        bargs = (q, k, v, do, lse, (out.float() * do.float()).sum(dim=-1))
        for kern, outs, products, tol_names in ((dq, 1, 3, ("dq",)), (dkv, 2, 4, ("dk", "dv"))):
            cost = (flash_bwd_cost(bargs, outs, products) if dt == bf16
                    else f32_flash_cost(shape, products))
            plain = flash_attention_dq_reference if kern is dq else flash_attention_dkv_reference
            check_kernel(kern.__name__, f"{kern.__name__} {label}", bargs, kern, plain,
                         [(t, bwd_tol) for t in tol_names], cost=cost, shape=label)
    args = scan_inputs(4, MM_PREFIX + 512, gen=g_img)
    args = args[:4] + (None, bf16, True)
    label = (f"{tuple(args[2].shape)} with every state (multimodal training: 197 image + 512 "
             f"text tokens), chunks of {FWD_CHUNK}")
    check_kernel("selective_scan_fwd", f"scan B=4 L={MM_PREFIX + 512} {label}", args,
                 selective_scan_fwd, selective_scan_fwd_reference, scan_h_tols, repeat=True,
                 cost=scan_cost(args), shape=label)
    args, hs_plain = scan_bwd_inputs(4, MM_PREFIX + 512, gen=g_img)
    label = (f"B=4 L={MM_PREFIX + 512} H={ssm_heads} (multimodal training), chunks of "
             f"{BWD_CHUNK}")
    check_kernel("selective_scan_bwd", f"scan backward {label}", args, selective_scan_bwd,
                 plain_scan_bwd(hs_plain), scan_bwd_tols(bf16), cost=scan_bwd_cost(args),
                 repeat=True, shape=label)

    # ---- 3g. the carried-state scan (#2) ---------------------------------------
    # The sequence-parallel path's scan, at the 1.5B model's whole training
    # sequence (4, 38, 1024, 16) and at a rank's chunk of it under seq = 2
    # (4, 38, 512, 16, the timed shape), f32, from zero and from an h_init,
    # forward and backward (the plain backward on the plain forward's
    # states). The kernels round every product and sum once, both over
    # chunks of the time axis (their carries reassociate the sums): the
    # report says whether each is bit-equal, which each is only where L fits
    # one chunk (the forward's one-chunk case must be).
    log("the carried-state scan (#2) against its plain versions (f32):")
    carry_bit_equal = {}

    def carry_inputs(shape, with_init):
        a = torch.empty(shape, device=dev).uniform_(0.4, 0.999, generator=g)
        h0 = randn(shape[0], shape[1], shape[3], dtype=f32) if with_init else None
        return a, randn(*shape, dtype=f32), h0

    def carry_bwd_inputs(a, b, h0):
        states = selective_scan_carry_fwd_reference(a, b, h0, want_states=True)[2]
        g_last = randn(a.shape[0], a.shape[1], a.shape[3], dtype=f32)
        return a, randn(*a.shape, dtype=f32), states, h0, g_last

    def carry_tols(with_init):
        fwd = [("h", CARRY_TOL), ("h_last", CARRY_TOL)]
        bwd = [("da", CARRY_BWD_TOL), ("db", CARRY_BWD_TOL)]
        return fwd, bwd + ([("dh_init", CARRY_BWD_TOL)] if with_init else [])

    def bit_equal(label, kernel, plain, args):
        got, ref = kernel(*args), plain(*args)
        same = all(x is None and y is None or torch.equal(x, y) for x, y in zip(got, ref))
        carry_bit_equal[label] = same
        log(f"  {label}: bit-equal to the plain version: {same}")

    # The checks can see the carried state and the h_last cotangent: without
    # either the plain outputs move by more than 9 tolerances.
    fargs = carry_inputs((2, 5, 300, 16), True)
    bargs = carry_bwd_inputs(*fargs)
    fwd_tols, bwd_tols = carry_tols(True)
    check_sensitive("selective_scan_carry_fwd", selective_scan_carry_fwd_reference, fargs,
                    {"h_init": fargs[:2] + (None,)}, fwd_tols, SENSITIVITY_FACTOR)
    check_sensitive("selective_scan_carry_bwd", selective_scan_carry_bwd_reference, bargs, {
        "h_init (as h[-1])": lambda: selective_scan_carry_bwd_reference(
            *bargs[:3], torch.zeros_like(bargs[3]), bargs[4]),
        "h_last cotangent": bargs[:4] + (None,)}, bwd_tols, SENSITIVITY_FACTOR)
    # The forward's chunks do not divide L = 300: from h_init, f32, and with
    # b in bf16 and its f32 states; then at L = CARRY_FWD_CHUNK (one chunk,
    # one launch), where it must give the plain version's bits.
    check_kernel("selective_scan_carry_fwd", f"scan carry forward (2, 5, 300, 16) from h_init, "
                 f"chunks of {CARRY_FWD_CHUNK}", fargs, selective_scan_carry_fwd,
                 selective_scan_carry_fwd_reference, fwd_tols, repeat=True)
    check_kernel("selective_scan_carry_fwd", "scan carry forward (2, 5, 300, 16) from h_init, "
                 "b in bf16 with its f32 states", (fargs[0], fargs[1].to(bf16), fargs[2], True),
                 selective_scan_carry_fwd, selective_scan_carry_fwd_reference,
                 [("h", BF16_ULP), ("h_last", BF16_ULP), ("states", CARRY_TOL)], repeat=True)
    one_chunk = tuple(x[:, :, :CARRY_FWD_CHUNK].contiguous() for x in fargs[:2]) + fargs[2:]
    label = f"scan carry forward {tuple(one_chunk[0].shape)} from h_init (one chunk)"
    bit_equal(label, selective_scan_carry_fwd, selective_scan_carry_fwd_reference, one_chunk)
    if not carry_bit_equal[label]:
        raise RuntimeError(f"{label}: one chunk must give the plain version's bits")
    # The backward's chunks do not divide L = 300; with and without g_last.
    for bargs_, what in ((bargs, "with g_last"), (bargs[:4] + (None,), "without g_last")):
        check_kernel("selective_scan_carry_bwd", f"scan carry backward (2, 5, 300, 16) {what}",
                     bargs_, selective_scan_carry_bwd, selective_scan_carry_bwd_reference,
                     bwd_tols, repeat=True)
    for shape in ((4, ssm_heads, 1024, n), (4, ssm_heads, 512, n)):
        for with_init in (False, True):
            fargs = carry_inputs(shape, with_init)
            bargs = carry_bwd_inputs(*fargs)
            fwd_tols, bwd_tols = carry_tols(with_init)
            timed = shape[2] == 512 and with_init
            label = f"{shape} {'from h_init' if with_init else 'from zero'}"
            a, b_, h0 = fargs
            cost = (nbytes(a, b_, h0) + nbytes(b_) + nbytes(a[:, :, 0]), 2 * a.numel(), "f32")
            check_kernel("selective_scan_carry_fwd", f"scan carry forward {label}", fargs,
                         selective_scan_carry_fwd, selective_scan_carry_fwd_reference, fwd_tols,
                         cost=cost if timed else None)
            bwd_plain = (selective_scan_carry_bwd_reference if with_init else
                         lambda *x: selective_scan_carry_bwd_reference(*x)[:2])
            bwd_kernel = (selective_scan_carry_bwd if with_init else
                          lambda *x: selective_scan_carry_bwd(*x)[:2])
            cost = (nbytes(*(t for t in bargs if t is not None)) + 2 * nbytes(a)
                    + nbytes(h0), 3 * a.numel(), "f32")
            check_kernel("selective_scan_carry_bwd", f"scan carry backward {label}", bargs,
                         bwd_kernel, bwd_plain, bwd_tols, cost=cost if timed else None,
                         repeat=True)
            bit_equal(f"scan carry forward {label}", selective_scan_carry_fwd,
                      selective_scan_carry_fwd_reference, fargs)
            bit_equal(f"scan carry backward {label}", selective_scan_carry_bwd,
                      selective_scan_carry_bwd_reference, bargs)
            if timed:
                repeats(f"selective_scan_carry_fwd {label}", selective_scan_carry_fwd, fargs)

    # ---- 3i. the decode kernels' f32 forms ------------------------------------
    library["mha_decode_ctx_f32"] = f32_forms_phase(checks, dev)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 4. serve -----------------------------------------------------------
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
    counters = (selective_scan_fwd, ssm_decode_step, ffn_decode, ln_quantize,
                ssm_decode_step_int8, ffn_decode_int8, expert_ffn_fat, expert_ffn_grouped,
                mha_decode_ctx, mha_decode_ctx_int8, flash_attention_fwd,
                quant_matmul_dyn_pre_q, ffn_decode_int4, expert_ffn_fat_int4, quant_matmul,
                quant_matmul_dyn_fused, expert_ffn_dense)
    launches, serve = {}, {}

    def product(mode):
        """The kernel an int8 linear on rows not quantized already runs in
        ``quant_matmul`` mode ``mode`` (None: plain torch)."""
        return {"dyn": "quant_matmul_dyn_pre_q", "pallas": "quant_matmul",
                "fused": "quant_matmul_dyn_fused"}.get(resolve_mode(mode))

    def expected_launches(kind, cfg, decode_calls, bits, moe_groups=0, quant_matmul_="dyn",
                          moe_mode="fatk", vit=None):
        """Each kernel's launches in the two requests: layers x calls.
        ``decode_calls``: each request's decode steps, by name;
        ``moe_groups``: the expert groups moe_ragged ran over all layers;
        ``quant_matmul_`` and ``moe_mode``: the engine's modes (``auto``'s
        pre-norms fused by their rows); ``vit``: the image prefix's ViT,
        "bf16" or "int8" (None: no images)."""
        nl = cfg.num_hidden_layers
        moe, mha = bool(cfg.use_expert_system), cfg.attention_type == "standard_mha"
        int8 = "bf16" not in kind
        fused_ffn = cfg.hidden_size % 128 == 0 and pick_block_n(cfg.intermediate_size) > 0
        n_req = len(requests)
        steps = sum(decode_calls.values())
        num_img = cfg.num_image_tokens if vit else 0
        # (rows a decode step, rows of the prefill, decode steps) a request.
        reqs = []
        for name, (ids, _, _) in requests.items():
            bucket = _round_up_bucket(ids.shape[1], InferenceEngine.PROMPT_BUCKETS)
            bucket += -(num_img + bucket) % 8
            reqs.append((ids.shape[0], ids.shape[0] * (num_img + bucket), decode_calls[name]))
        exp = {f.__name__: 0 for f in counters}
        # The int8 pre-norms fused with their row quantization, a layer and
        # prefill where the mode fuses them at the prefill's rows: the SSM
        # mixer's (two consumers) and the dense FFN's (one; a MoE FFN's
        # pre-norm is the plain norm, since the router reads it; MHA's
        # pre-norm is always the plain norm).
        lnq = (0 if mha else 1) + (0 if moe else 1)
        lnq_consumers = (0 if mha else 2) + (0 if moe else 1)
        if int8:
            exp["ln_quantize"] = sum(lnq * nl for _, rows, _ in reqs
                                     if fuses_pre_norm(quant_matmul_, rows))
        if mha:
            # Serving prefill carries the padding mask, so the plain attention
            # runs there and the flash kernel never.
            exp["mha_decode_ctx_int8" if int8 else "mha_decode_ctx"] = nl * steps
        else:
            exp["selective_scan_fwd"] = nl * n_req
            exp["ssm_decode_step_int8" if int8 else "ssm_decode_step"] = nl * steps
        if moe and moe_mode == "kernel":
            # Request A's 256 prefill rows and every decode step through the
            # per-expert kernel; request B's 2048 rows through moe_ragged.
            exp["expert_ffn_dense"] = nl * (steps + 1)
        elif moe:
            # Request A prefills 4 x 64 = 256 rows (the fat kernel), request
            # B 64 x 32 = 2048 (the grouped kernel, or moe_ragged over an
            # int4 fat stack); every decode step runs the fat kernel. With
            # the image prefix request A prefills 4 x (197 + 67) rows, past
            # the fat kernel's 256: the grouped kernel. Under "fat" the fat
            # stack's products at A's prefill and every decode step are
            # plain torch (moe_dense_fat).
            fat = "expert_ffn_fat_int4" if bits == 4 else "expert_ffn_fat"
            exp[fat] = 0 if moe_mode == "fat" else nl * (steps + (0 if vit else 1))
            exp["expert_ffn_grouped"] = 0 if bits == 4 else nl * (2 if vit else 1)
        elif fused_ffn:
            exp[{4: "ffn_decode_int4", 8: "ffn_decode_int8"}[bits] if int8
                else "ffn_decode"] = nl * steps
        if int8:
            # The mode's product: per layer and prefill the mixer's four
            # projections (q, k, v, o for MHA) and, for a dense FFN, w1 and
            # w2, at the prefill's rows, but the w8a8 product for a fused
            # pre-norm's consumers; the int8 head once per prefill and
            # decode step, and at decode an unfused FFN's w1 and w2, at the
            # batch's rows. The w8a8 product (in every mode): at decode MHA's
            # fused QKV and o; under dyn two per expert group of moe_ragged.
            per_prefill = 4 + (0 if moe else 2)
            per_step = 0 if moe or fused_ffn else 2
            for b, rows, n in reqs:
                fused_in = lnq_consumers if fuses_pre_norm(quant_matmul_, rows) else 0
                exp["quant_matmul_dyn_pre_q"] += nl * fused_in
                if product(quant_matmul_) is not None:
                    exp[product(quant_matmul_)] += (nl * (per_prefill - fused_in)
                                                    + 1 + n * (nl * per_step + 1))
            exp["quant_matmul_dyn_pre_q"] += (steps * nl * (2 if mha else 0)
                                              + (2 * moe_groups if quant_matmul_ == "dyn" else 0))
        if vit == "int8":
            # A request's int8 ViT: ln1 and ln2 a layer through ln_quantize
            # where the mode fuses them (their consumers in_proj and linear1
            # then through the w8a8 product), four products a layer, the
            # patch embedding and vision_proj.
            nv = cfg.vision_layers
            for b, _, _ in reqs:
                fused_in = 2 * nv if fuses_pre_norm(quant_matmul_, b * cfg.num_image_tokens) else 0
                exp["ln_quantize"] += fused_in
                exp["quant_matmul_dyn_pre_q"] += fused_in
                if product(quant_matmul_) is not None:
                    exp[product(quant_matmul_)] += 4 * nv + 2 - fused_in
        return exp

    def serve_model(kind, m, cfg, bits=8, quant_matmul_="dyn", moe_mode="fatk", images=None,
                    vit=None, text_kind=None, timed=True):
        """Both requests through InferenceEngine.generate with the counts set
        to 0 before and checked after, then repeat identity and (``timed``)
        TTFT and decode tok/s; with ``images`` (one batch a request) each request
        carries them, ``vit`` names the ViT's layout for the counts and the
        figures are printed beside ``text_kind``'s, the same model without
        them."""
        pix = {name: {} if images is None else {"pixel_values": images[name]}
               for name in requests}
        nl = cfg.num_hidden_layers
        moe, mha = bool(cfg.use_expert_system), cfg.attention_type == "standard_mha"
        engine = InferenceEngine(cfg, m, quant_bits=bits, quant_matmul=quant_matmul_,
                                 moe_mode=moe_mode)
        if "bf16" not in kind and m.lm_head is None:
            raise RuntimeError("the engine did not attach the int8 head")
        if mha and (engine.kv_int8 != ("bf16" not in kind)
                    or (m.layers[0].attn.fused_qkv() is not None) != ("bf16" not in kind)):
            raise RuntimeError(f"{kind}: KV cache or fused QKV not as the engine's defaults")
        if bits == 4 and not moe and m.layers[0].ffn.int4_pack() is None:
            raise RuntimeError(f"{kind}: the engine did not attach the int4 FFN pack")
        groups = []
        real_ragged = moe_ops.moe_ragged

        def ragged(x, routing, *rest):
            groups.append(len(set(routing.indices.reshape(-1).tolist())))
            return real_ragged(x, routing, *rest)

        moe_ops.moe_ragged = ragged
        # An MHA cache behind the image prefix holds num_img + bucket +
        # max_new_tokens slots (the prefix first).
        slots, want_slots = [], []
        if mha and images is not None:
            real_init = m.init_cache
            m.init_cache = lambda *a, **k: slots.append(k["max_length"]) or real_init(*a, **k)
            for ids, _, kw in requests.values():
                bucket = _round_up_bucket(ids.shape[1], InferenceEngine.PROMPT_BUCKETS)
                bucket += -(cfg.num_image_tokens + bucket) % 8
                want_slots.append(cfg.num_image_tokens + bucket + kw["max_new_tokens"])
        for f in counters:
            f.launches = 0
        first = {}
        for name, (ids, mask, kw) in requests.items():
            first[name] = engine.generate(ids, attention_mask=mask, **pix[name], **kw)
        got = {f.__name__: f.launches for f in counters}
        moe_ops.moe_ragged = real_ragged
        if want_slots:
            del m.init_cache
            log(f"{kind}: KV cache slots {slots} (expected {want_slots}: the image prefix, the "
                "bucket and the new tokens)")
            if slots != want_slots:
                raise RuntimeError(f"{kind}: the KV caches do not hold the image prefix")
        decode_calls = {}
        for name, (ids, _, kw) in requests.items():
            out = first[name]
            n_new = out.shape[1] - ids.shape[1]
            if out.shape[0] != ids.shape[0] or not 1 <= n_new <= kw["max_new_tokens"]:
                raise RuntimeError(f"{kind} request {name}: output shape {out.shape}")
            if not np.array_equal(out[:, :ids.shape[1]], ids):
                raise RuntimeError(f"{kind} request {name}: prompt columns changed")
            new = out[:, ids.shape[1]:]
            if new.min() < 0 or new.max() >= cfg.vocab_size:
                raise RuntimeError(f"{kind} request {name}: token outside "
                                   f"[0, {cfg.vocab_size})")
            decode_calls[name] = n_new - 1
            log(f"{kind} request {name}: {n_new} new tokens, first row "
                f"{new[0, :8].tolist()}...")
        if moe and (bits == 4 or moe_mode == "kernel") and len(groups) != nl:
            raise RuntimeError(f"{kind}: moe_ragged ran {len(groups)} times, not once per layer "
                               "of request B")
        expected = expected_launches(kind, cfg, decode_calls, bits, sum(groups), quant_matmul_,
                                     moe_mode, vit)
        log(f"{kind} launch counts in the two requests: {got} (expected {expected}"
            f"{f'; moe_ragged expert groups {sum(groups)}' if groups else ''})")
        if got != expected:
            raise RuntimeError(f"{kind}: a kernel of the main path was not launched as expected")
        for key, value in got.items():
            if moe and moe_mode == "fatk" and key in ("ssm_decode_step", "ssm_decode_step_int8"):
                key += "_moe"     # the step with its moe epilogue
            launches[key] = launches.get(key, 0) + value

        for name, (ids, mask, kw) in requests.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = engine.generate(ids, attention_mask=mask, **pix[name], **kw)
            total = time.perf_counter() - t0
            if not np.array_equal(again, first[name]):
                raise RuntimeError(f"{kind} request {name}: a repeated request gave other tokens")
            if not timed:
                log(f"serve {kind} {name}: repeat identical (untimed)")
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(ids, attention_mask=mask, **pix[name], **dict(kw, max_new_tokens=1))
            ttft = time.perf_counter() - t0
            steps = again.shape[1] - ids.shape[1] - 1
            rate = ids.shape[0] * steps / max(total - ttft, 1e-9)
            beside = serve.get(f"{text_kind} {name[0]}")
            log(f"serve {kind} {name}: TTFT {ttft * 1e3:.1f} ms, decode {rate:.1f} tok/s "
                f"({steps} steps x {ids.shape[0]} rows, {total:.3f} s in all), "
                f"repeat identical"
                + (f"; without images ({text_kind}): TTFT {beside['ttft_ms']:.1f} ms, decode "
                   f"{beside['decode_tok_s']:.1f} tok/s" if beside else "") + f"; card: {card}")
            serve[f"{kind} {name[0]}"] = dict(ttft_ms=ttft * 1e3, decode_tok_s=rate)

    for kind, m, cfg in (("bf16", model, config), ("int8", qmodel, config),
                         ("MoE bf16", moe_model, moe_config),
                         ("MoE int8", moe_qmodel, moe_config),
                         ("MHA bf16", mha_model, mha_config),
                         ("MHA int8", mha_qmodel, mha_config)):
        serve_model(kind, m, cfg)
    # The selectable int8 arithmetic, beside dyn and fatk above: the dense
    # int8 model's linears through #6 (what quant_matmul="auto" runs on rows
    # not quantized already), under auto itself (its pre-norms fused by
    # their rows) and through #8, the MoE int8 model's FFN through #11
    # (request B's prefill through moe_ragged); the auto, #8 and #11 serves
    # untimed (counts and repeat identity) to hold the smoke's time.
    for kind, m, cfg, qm_, mm_ in (("int8 pallas", qmodel, config, "pallas", "fatk"),
                                   ("int8 auto", qmodel, config, "auto", "fatk"),
                                   ("int8 fused", qmodel, config, "fused", "fatk"),
                                   ("MoE int8 kernel", moe_qmodel, moe_config, "dyn", "kernel")):
        serve_model(kind, m, cfg, 8, qm_, mm_, timed=qm_ == "pallas")
    for m in (qmodel, moe_qmodel):
        m.set_modes("dyn", "fatk")

    # The image prefix (bench.py's multimodal flagship): ViT-B/16 at 224 (12
    # layers of 768, 12 heads, 197 tokens) and vision_proj, added to the
    # dense and MoE models above from seeded noisy trees; each request with
    # seeded uint8 images of another size than 224, so the resize runs.
    images = {name: np.random.default_rng(SEED + 50 + i).integers(
        0, 256, (ids.shape[0], *size, 3)).astype(np.uint8)
        for i, ((name, (ids, _, _)), size) in enumerate(zip(requests.items(),
                                                            ((160, 200), (256, 320))))}

    def with_prefix(m, cfg, seed, int8_vit):
        """The model ``m`` with a ViT prefix drawn from ``seed`` (int8 with
        ``int8_vit``, quantize_params(quantize_vision=True)), and its
        config."""
        mcfg = dataclasses.replace(cfg, multimodal=True)
        vtree = init_params(dataclasses.replace(mcfg, num_hidden_layers=1),
                            torch.Generator(device=dev).manual_seed(seed), device=dev,
                            dtype=bf16)
        sub = {k: vtree[k] for k in ("vision", "vision_proj")}
        del vtree
        perturb_(sub, torch.Generator(device=dev).manual_seed(seed + 1))
        if int8_vit:
            sub = quantize_params(sub, quantize_vision=True)
        mm = from_jax_params(dict(params_tree(m), **sub), mcfg, device=dev, dtype=bf16)
        return mm, mcfg

    for kind, m, cfg, int8_vit, text_kind in (
            # (The kind names "bf16" only for the bf16 model: serve_model
            # reads the layout from it.)
            ("bf16 + ViT", model, config, False, "bf16"),
            ("int8 + ViT", qmodel, config, False, "int8"),
            ("int8 + int8 ViT", qmodel, config, True, "int8"),
            ("MoE int8 + ViT", moe_qmodel, moe_config, False, "MoE int8"),
            ("MHA bf16 + ViT", mha_model, mha_config, False, "MHA bf16"),
            ("MHA int8 + int8 ViT", mha_qmodel, mha_config, True, "MHA int8")):
        mm, mcfg = with_prefix(m, cfg, SEED + 60, int8_vit)
        log(f"{kind}: {sum(p.numel() for p in mm.parameters()):,} parameters with the prefix "
            f"(ViT {mcfg.vision_layers} x {mcfg.vision_embed_dim}, {mcfg.num_image_tokens} "
            f"tokens), ViT {'int8' if int8_vit else 'bf16'}")
        serve_model(kind, mm, mcfg, images=images, text_kind=text_kind,
                    vit=("int8" if int8_vit else "bf16"))
        del mm
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 5. outputs are right -----------------------------------------------
    def cache_kw(m, width, int8, num_img=0):
        """init_cache's arguments: an MHA cache of the image prefix, the
        prompt's width and eight slots, int8 for an int8 model as the engine
        allocates it."""
        if m.config.attention_type != "standard_mha":
            return {}
        return dict(max_length=num_img + width + 8, kv_int8=int8)

    def step_kw(m, mask, i, num_img=0):
        """decode_step's MHA arguments for step i after a prefill of an image
        prefix and width W, as the engine gives them: slot num_img + W + i,
        positions num_img + len + i, the prefix, the prompt's mask and the
        slots generated so far valid; an SSM model with absolute positions
        takes the positions only."""
        if m.config.attention_type != "standard_mha":
            if m.config.position_embedding_type == "absolute":
                return dict(positions=(num_img + mask.sum(1) + i).to(m.device))
            return {}
        b, w = mask.shape
        row = torch.zeros((b, num_img + w + 8), dtype=torch.int32, device=m.device)
        row[:, :num_img] = 1
        row[:, num_img:num_img + w] = mask.to(m.device)
        row[:, num_img + w:num_img + w + i + 1] = 1
        return dict(t=num_img + w + i, attn_mask_row=row,
                    positions=(num_img + mask.sum(1) + i).to(m.device))

    mask_a_t = torch.as_tensor(mask_a)
    for kind, m in (("bf16", model), ("int8", qmodel), ("MoE bf16", moe_model),
                    ("MoE int8", moe_qmodel), ("MHA bf16", mha_model),
                    ("MHA int8", mha_qmodel)):
        cache = m.init_cache(4, **cache_kw(m, batch_a.shape[1], "int8" in kind))
        pre = m.prefill(cache, torch.as_tensor(batch_a, dtype=torch.long, device=dev),
                        torch.as_tensor(mask_a, device=dev),
                        logit_positions=torch.as_tensor(mask_a.sum(1) - 1, device=dev))
        logits, _ = m.decode_step(cache, pre.logits[:, 0].argmax(-1), **step_kw(m, mask_a_t, 0))
        if (pre.logits.shape != (4, 1, config.vocab_size)
                or logits.shape != (4, config.vocab_size)):
            raise RuntimeError(f"1.5B {kind} logits have the wrong shape")
        if not (torch.isfinite(pre.logits).all() and torch.isfinite(logits).all()):
            raise RuntimeError(f"1.5B {kind} logits are not finite")
        log(f"1.5B {kind} prefill and decode logits: finite, shapes (4, 1, 32000) and "
            "(4, 32000)")

    # The 1.5B MHA forward() without a mask, with use_flash_attention: the
    # flash kernel once per layer, against the same weights' forward() through
    # the plain attention on the card.
    ids_f = torch.randint(4, mha_config.vocab_size, (2, 512), generator=g, device=dev)
    for f in counters:
        f.launches = 0
    mha_model.config = dataclasses.replace(mha_config, use_flash_attention=True)
    with torch.no_grad():
        logits_flash = mha_model(ids_f)
    torch.cuda.synchronize()
    launches["flash_attention_fwd"] = flash_attention_fwd.launches
    log(f"1.5B MHA forward() B=2 L=512 without a mask: flash_attention_fwd launched "
        f"{flash_attention_fwd.launches} times (expected {mha_config.num_hidden_layers})")
    if flash_attention_fwd.launches != mha_config.num_hidden_layers:
        raise RuntimeError("forward() did not run the flash kernel once per layer")
    mha_model.config = mha_config
    with torch.no_grad():
        logits_plain = mha_model(ids_f)
    if flash_attention_fwd.launches != mha_config.num_hidden_layers:
        raise RuntimeError("forward() ran the flash kernel with use_flash_attention off")
    flash_forward_err = compare("1.5B MHA forward() logits, flash kernel vs plain attention",
                                logits_flash, logits_plain, FLASH_FORWARD_TOL)
    del model, moe_model, moe_qmodel, mha_model

    # ---- 4b. w4a8 serving; int8 at a width that is not a multiple of 128 ----
    dims500 = calculate_model_dimensions("500M", 32000)
    config500 = dataclasses.replace(
        config, hidden_size=dims500["hidden_size"], num_hidden_layers=dims500["num_hidden_layers"],
        num_attention_heads=dims500["num_attention_heads"],
        intermediate_size=dims500["intermediate_size"])
    tree = init_params(config500, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=bf16)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 11))
    qtree = quantize_params(tree)
    del tree
    model500 = from_jax_params(qtree, config500, device=dev, dtype=bf16)
    del qtree
    log(f"500M model: hidden {config500.hidden_size} (not a multiple of 128), "
        f"{config500.num_hidden_layers} layers, {config500.num_attention_heads} heads, FFN "
        f"{config500.intermediate_size}, int8: the decode FFN runs unfused "
        f"(fused_decode {model500.layers[0].ffn.fused_decode})")
    for kind, m, cfg, bits in (("w4a8", qmodel, config, 4), ("MHA w4a8", mha_qmodel, mha_config, 4),
                               ("MoE 3B w4a8", moe3_model, moe3_config, 4),
                               ("500M int8", model500, config500, 8)):
        serve_model(kind, m, cfg, bits)
        cache = m.init_cache(4, **cache_kw(m, batch_a.shape[1], True))
        pre = m.prefill(cache, torch.as_tensor(batch_a, dtype=torch.long, device=dev),
                        torch.as_tensor(mask_a, device=dev),
                        logit_positions=torch.as_tensor(mask_a.sum(1) - 1, device=dev))
        logits, _ = m.decode_step(cache, pre.logits[:, 0].argmax(-1), **step_kw(m, mask_a_t, 0))
        if not (pre.logits.shape == (4, 1, cfg.vocab_size) and logits.shape == (4, cfg.vocab_size)
                and torch.isfinite(pre.logits).all() and torch.isfinite(logits).all()):
            raise RuntimeError(f"{kind} logits are not finite or of the wrong shape")
        log(f"{kind} prefill and decode logits: finite, shapes (4, 1, 32000) and (4, 32000)")
    del qmodel, mha_qmodel, moe3_model, model500
    log(f"phase 4b done at {time.perf_counter() - t_start:.1f} s")

    # ---- 4c. the 1.5B MHA + MoE model ------------------------------------------
    # What ``create-model --target-params 1.5B --expert-system`` builds: the
    # MoE preset's widths (hidden 704, 44 layers, 8 experts of 2816, top-2)
    # with the config's default mixer, standard MHA: 11 heads of 64 (dropout
    # 0 gives q/k/v/o biases). Its kernel checks draw from the shared
    # generator, whose state is given back after them.
    g_state = g.get_state()
    mm_config = dataclasses.replace(moe_config, attention_type="standard_mha")
    t0 = time.perf_counter()
    tree = init_params(mm_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=bf16)
    mm_params = count_params(tree)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 71))
    mm_model = from_jax_params(tree, mm_config, device=dev, dtype=bf16)
    qtree = quantize_params(tree)
    del tree
    mm_qmodel = from_jax_params(qtree, mm_config, device=dev, dtype=bf16)
    del qtree
    mm_heads = mm_config.num_attention_heads
    log(f"MHA + MoE model: {mm_params:,} parameters, hidden {mm_config.hidden_size}, "
        f"{mm_config.num_hidden_layers} layers, {mm_heads} heads of {mm_config.head_dim}, "
        f"{mm_config.num_experts} experts of {mm_config.intermediate_size} (top-"
        f"{mm_config.experts_per_token}), bf16 and int8, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # #9 at its caches (request A's 4 x 88 slots, B's 64 x 96), #10 on its
    # first layer's fat stack at 64 decode rows routed by that layer's
    # router, #12 on it at request B's 2048 tokens: the report's other shapes.
    for b, l in ((4, 88), (64, 96)):
        for int8_ in (False, True):
            key = "mha_decode_ctx_int8" if int8_ else "mha_decode_ctx"
            args = decode_ctx_inputs(b, l, mm_heads, mm_config.head_dim, int8=int8_)
            check_kernel(key, f"{key} B={b} L={l} {mm_heads}x{mm_config.head_dim} (MHA + MoE)",
                         args, mha_decode_ctx_int8 if int8_ else mha_decode_ctx,
                         decode_ctx_int8_plain if int8_ else mha_decode_ctx_reference, ctx_tols,
                         cost=decode_ctx_cost(args), shape=f"MHA + MoE {b} x {l} slots")
            if not int8_:
                shape_times[key][f"MHA + MoE {b} x {l} slots"]["library_ms"] = sdpa_decode_ms(
                    args)
    mm_qmodel.attach_moe_fat()
    mm_ffn = mm_qmodel.layers[0].ffn
    args = fat_inputs(64, ffn=mm_ffn, fat_=mm_ffn.experts.fat())
    check_kernel("expert_ffn_fat", "expert_ffn_fat S=64, the MHA + MoE model's first stack", args,
                 expert_ffn_fat, expert_ffn_fat_reference, fat_tols, cost=fat_cost(args),
                 shape="MHA + MoE, 64 rows")
    args = grouped_inputs(2048, probs, fat_=mm_ffn.experts.fat())
    check_kernel("expert_ffn_grouped", "expert_ffn_grouped 2048 tokens, the MHA + MoE model's "
                 "first stack", args, expert_ffn_grouped, expert_ffn_grouped_reference,
                 [("out", BF16_ULP)], cost=grouped_cost(args, 4096),
                 shape="MHA + MoE, 2048 tokens")
    # Requests A and B in bf16 and int8 under the engine's defaults (auto,
    # fatk), and in int8 under moe_mode="fat"; the int8 defaults timed and
    # repeated, the others their counts only (their decode steps are
    # host-bound, 150-170 ms at 64 rows, and the smoke's time is bounded).
    for kind, m, mm_ in (("MHA MoE bf16", mm_model, "fatk"), ("MHA MoE int8", mm_qmodel, "fatk"),
                         ("MHA MoE int8 fat", mm_qmodel, "fat")):
        serve_model(kind, m, mm_config, 8, "auto", mm_, timed=kind == "MHA MoE int8")
    # fat against fatk: one MoE layer's FFN (the model's first) on the same
    # routed rows, request A's prefill (180 rows) and a decode step's 64,
    # within the card-vs-CPU tolerance (4 bf16 ulps of the largest output;
    # the kernel requantizes the hidden per hidden tile, the plain products
    # per row). Through the whole model the modes part further; the witness
    # that this is the routing and not fat: request A's prefill and three
    # decode steps (every mode fed fatk's greedy tokens) through the 44
    # layers under fat, under kernel (the per-expert kernel #11) and under
    # 0 (moe_dense, the experts dequantized), each against fatk: the logits'
    # largest error, the rows with fatk's greedy token, and a layer's count
    # of tokens whose top-2 experts are not fatk's (with the first layer
    # that has one). Every logit must be finite; the figures are reported.
    fat_vs_fatk = {}
    for s_ in (180, 64):
        x = mm_ffn.pre_norm(torch.randn((s_, mm_config.hidden_size), generator=g,
                                        device=dev).to(bf16))
        routing = moe_ops.route(x, *mm_ffn.router_weights(), mm_config.experts_per_token,
                                layer_norm_eps=eps)
        b2 = mm_ffn.experts.b2
        fat_vs_fatk[f"FFN at {s_} rows"] = compare(
            f"MHA + MoE int8 layer 0 FFN at {s_} rows, moe_dense_fat vs the fat kernel",
            moe_ops.moe_dense_fat(x, routing, mm_ffn.experts.fat(), b2, mm_config.hidden_act,
                                  eps),
            moe_ops.moe_dense_fat_kernel(x, routing, mm_ffn.experts.fat(), b2,
                                         mm_config.hidden_act, eps), 4 * BF16_ULP)
    g.set_state(g_state)
    ids_a = torch.as_tensor(batch_a, dtype=torch.long, device=dev)
    mm_qmodel.attach_moe_fused()
    real_route = moe_ops.route
    runs, routes = {}, {}
    for mode in ("fatk", "fat", "kernel", "0"):
        mm_qmodel.set_modes("auto", mode)
        routes[mode] = []
        moe_ops.route = lambda *a, _r=routes[mode], **k: (
            lambda out: _r.append(out.indices.sort(-1).values) or out)(real_route(*a, **k))
        cache = mm_qmodel.init_cache(4, **cache_kw(mm_qmodel, batch_a.shape[1], True))
        pre = mm_qmodel.prefill(cache, ids_a, torch.as_tensor(mask_a, device=dev),
                                logit_positions=torch.as_tensor(mask_a.sum(1) - 1, device=dev))
        runs[mode] = [pre.logits[:, 0]]
        for i in range(3):
            tok = runs["fatk"][i].argmax(-1)
            runs[mode].append(mm_qmodel.decode_step(cache, tok, **step_kw(mm_qmodel, mask_a_t,
                                                                            i))[0])
        moe_ops.route = real_route
    nl_mm = mm_config.num_hidden_layers
    for mode in ("fat", "kernel", "0"):
        if len(routes[mode]) != 4 * nl_mm:
            raise RuntimeError(f"MHA + MoE int8 under {mode}: {len(routes[mode])} routings, "
                               f"not {4 * nl_mm}")
        for i, (a, b_) in enumerate(zip(runs[mode], runs["fatk"])):
            if not (torch.isfinite(a).all() and torch.isfinite(b_).all()):
                raise RuntimeError(f"MHA + MoE int8 logits of step {i} under {mode} are not "
                                   "finite")
            err = float((a.float() - b_.float()).abs().max()) / float(b_.float().abs().max())
            same = float((a.argmax(-1) == b_.argmax(-1)).float().mean())
            # A layer's tokens (256 at the prefill, 4 at a step) routed to
            # another pair of experts than under fatk.
            flips = [int((r != f).any(-1).sum()) for r, f in
                     zip(routes[mode][i * nl_mm:(i + 1) * nl_mm],
                         routes["fatk"][i * nl_mm:(i + 1) * nl_mm])]
            first = next((j for j, n_ in enumerate(flips) if n_), None)
            fat_vs_fatk[f"{mode} vs fatk, logits of step {i}"] = {
                "max_err_over_max": err, "same_greedy": same, "route_flips": flips,
                "first_flip_layer": first}
            log(f"  MHA + MoE int8, {mode} vs fatk through {nl_mm} layers, step {i}: logits' "
                f"max error {err:.3e} of the largest, greedy tokens the same in {same:.2f} of "
                f"the rows; tokens routed otherwise a layer {flips} (first at layer {first}); "
                "finite ok")
    mm_qmodel.set_modes("auto", "fatk")
    del mm_model, mm_qmodel, runs
    log(f"phase 4c done at {time.perf_counter() - t_start:.1f} s")

    dense_small = dict(
        vocab_size=1000, attention_type="selective_ssm", ssm_d_state=16, hidden_size=256,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=1024,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype="bfloat16",
        param_dtype="bfloat16")
    # The MoE one prefills request A's 4 x 45 rows through the grouped kernel
    # (past its threshold of 64) and decodes through the fat kernel.
    moe_small = dict(dense_small, intermediate_size=512, use_expert_system=True, num_experts=8,
                     experts_per_token=2, moe_dense_threshold_tokens=64)
    mha_small = dict(dense_small, attention_type="standard_mha")     # 4 heads of 64
    # Hidden 192: the decode FFN runs unfused (fault 1's repair).
    narrow_small = dict(dense_small, hidden_size=192, num_attention_heads=4,
                        intermediate_size=768)
    # Heads of 96: the decode-attention kernel (#9) at a head width that is a
    # multiple of 32 but not a power of two, over a bf16 and an int8 cache.
    mha96_small = dict(mha_small, hidden_size=384)
    # 40 experts, more than the decode step's moe epilogue takes: every
    # decode step runs without it and then the MoE FFN (ROADMAP.md section 3,
    # fault 1).
    moe40_small = dict(moe_small, intermediate_size=256, num_experts=40)
    # The image prefix at tests/test_parity.py's ViT widths (48 wide, 2
    # layers, 4 heads, 32-pixel images of 8-pixel patches: 17 tokens), before
    # the dense and the MoE model; int8 with an int8 ViT.
    vit_small = dict(multimodal=True, image_size=32, vision_patch_size=8, vision_embed_dim=48,
                     vision_layers=2, vision_heads=4)
    # The variants beside the presets, each bf16 and int8, whose greedy
    # tokens must also be the CPU's: MHA with a MoE FFN (int8 also under
    # moe_mode="fat"), SwiGLU with either mixer, absolute positions with an
    # untied head (either mixer, MHA also behind the prefix), top-1 and
    # top-3 MoE, MHA at head widths 48 and 320 (the plain decode attention).
    absolute = dict(position_embedding_type="absolute", tie_word_embeddings=False)
    variant_small = (("MHA MoE ", dict(moe_small, attention_type="standard_mha")),
                     ("SwiGLU ", dict(dense_small, use_swiglu=True)),
                     ("SwiGLU MHA ", dict(mha_small, use_swiglu=True)),
                     ("abs ", dict(dense_small, **absolute)),
                     ("abs MHA ", dict(mha_small, **absolute)),
                     ("MM abs MHA ", dict(mha_small, **vit_small, **absolute)),
                     ("top-1 MoE ", dict(moe_small, experts_per_token=1)),
                     ("top-3 MoE ", dict(moe_small, experts_per_token=3)),
                     ("MHA Dh-48 ", dict(mha_small, hidden_size=192)),
                     ("MHA Dh-320 ", dict(mha_small, hidden_size=640, num_attention_heads=2)))
    variant_kinds = set()
    ids = torch.as_tensor(batch_a % 1000, dtype=torch.long)
    mask = torch.as_tensor(mask_a)
    mm_pixels = torch.as_tensor(np.random.default_rng(SEED + 14).integers(
        0, 256, (4, 40, 48, 3)).astype(np.uint8))
    small_err = {}
    cases = []
    for family, kw in (("", dense_small), ("MoE ", moe_small), ("MHA ", mha_small),
                       ("hidden-192 ", narrow_small), ("MHA Dh-96 ", mha96_small),
                       ("MoE-40 ", moe40_small), ("MM ", dict(dense_small, **vit_small)),
                       ("MM MoE ", dict(moe_small, **vit_small)),
                       ("MM MHA ", dict(mha_small, **vit_small)), *variant_small):
        small = ApertisConfig(**kw)
        if (family, kw) in variant_small:
            variant_kinds.update({family + "bf16", family + "int8"})
        tree = init_params(small, torch.Generator().manual_seed(SEED), device="cpu",
                           dtype=torch.bfloat16)
        perturb_(tree, torch.Generator().manual_seed(SEED + 3))
        if family.startswith("MM"):
            # quantize_params' rule quantizes the ViT's stacked LayerNorm
            # weights (2 x 48) at min_size 0: take every linear (the
            # smallest is attn_out, 2 x 48 x 48) and no norm.
            cases += [(family + "bf16", small, tree),
                      (family + "int8", small, quantize_params(tree, min_size=4096,
                                                               quantize_vision=True))]
            continue
        # min_size=0: at these widths the default would leave the mixer float.
        qtree = quantize_params(tree, min_size=0)
        if family == "hidden-192 ":
            cases.append((family + "int8", small, qtree))
            continue
        cases += [(family + "bf16", small, tree), (family + "int8", small, qtree)]
        if family in ("", "MoE "):
            # w4a8: the int4 decode FFN, or for MoE the int4 fat kernel at
            # decode and moe_ragged for request A's 180-row prefill.
            cases.append((family + "w4a8", small, qtree))
        if family == "":
            cases += [("int8 pallas", small, qtree), ("int8 fused", small, qtree)]
        if family == "MoE ":
            # The per-expert kernel at decode, moe_ragged for the prefill.
            cases.append(("MoE int8 kernel", small, qtree))
        if family == "MHA MoE ":
            cases.append(("MHA MoE int8 fat", small, qtree))
            variant_kinds.add("MHA MoE int8 fat")
    modes = {"int8 pallas": ("pallas", "fatk"), "int8 fused": ("fused", "fatk"),
             "MoE int8 kernel": ("dyn", "kernel"), "MHA MoE int8 fat": ("dyn", "fat")}
    for kind, small, t in cases:
        models = {"gpu": from_jax_params(t, small, device=dev, dtype=torch.bfloat16),
                  "cpu": from_jax_params(t, small, device="cpu", dtype=torch.bfloat16)}
        for m in models.values():
            if "bf16" not in kind:
                m.quantize_tied_head()
                m.attach_qkv()
                if "w4a8" in kind:
                    m.attach_int4_ffn()
                m.set_modes(*modes.get(kind, ("dyn", "fatk")))
            # A MoE model's serving stack, as InferenceEngine attaches it.
            if "MoE" in kind and "kernel" in kind:
                m.attach_moe_fused()
            elif "MoE" in kind:
                m.attach_moe_fat(bits=4 if "w4a8" in kind else 8)
        for f in counters:
            f.launches = 0
        num_img = small.num_image_tokens if kind.startswith("MM") else 0
        caches = {k: m.init_cache(4, **cache_kw(m, ids.shape[1], "int8" in kind, num_img))
                  for k, m in models.items()}
        pix = (lambda m: {"pixel_values": mm_pixels.to(m.device)}) if num_img \
            else (lambda m: {})
        logits = {k: m.prefill(caches[k], ids.to(m.device), mask.to(m.device),
                               logit_positions=(mask.sum(1) - 1).to(m.device),
                               **pix(m)).logits[:, 0]
                  for k, m in models.items()}
        small_err[kind] = 0.0
        for i in range(5):
            # Both sides decode the CPU side's argmax, so their inputs agree.
            small_err[kind] = max(small_err[kind], compare(
                f"2-layer {kind} model on the card vs the CPU, logits of step {i}",
                logits["gpu"].cpu(), logits["cpu"], 4 * BF16_ULP))
            tok = logits["cpu"].argmax(-1)
            if kind in variant_kinds:
                # The card's greedy token is the CPU's, except in a row whose
                # two best CPU logits lie within the tolerance of each other.
                ref = logits["cpu"].float()
                top2 = ref.topk(2, dim=-1).values
                tied = top2[:, 0] - top2[:, 1] <= 4 * BF16_ULP * float(ref.abs().max())
                differ = logits["gpu"].cpu().argmax(-1) != tok
                if bool((differ & ~tied).any()):
                    raise RuntimeError(f"2-layer {kind}: the card's greedy tokens of step {i} "
                                       "are not the CPU's")
            logits = {k: m.decode_step(caches[k], tok.to(m.device),
                                       **step_kw(m, mask, i, num_img))[0]
                      for k, m in models.items()}
        ran = {f.__name__: f.launches for f in counters if f.launches}
        must = {"w4a8": ["ffn_decode_int4", "quant_matmul_dyn_pre_q"],
                "MoE w4a8": ["expert_ffn_fat_int4", "quant_matmul_dyn_pre_q"],
                "hidden-192 int8": ["quant_matmul_dyn_pre_q"],
                "MHA Dh-96 bf16": ["mha_decode_ctx"],
                "MHA Dh-96 int8": ["mha_decode_ctx_int8", "quant_matmul_dyn_pre_q"],
                "MoE-40 bf16": ["expert_ffn_fat", "ssm_decode_step"],
                "MoE-40 int8": ["expert_ffn_fat", "ssm_decode_step_int8"],
                "MM int8": ["ffn_decode_int8", "quant_matmul_dyn_pre_q"],
                "MM MoE int8": ["expert_ffn_grouped", "expert_ffn_fat"],
                "MM MHA bf16": ["mha_decode_ctx"],
                "MM MHA int8": ["mha_decode_ctx_int8", "quant_matmul_dyn_pre_q"],
                "MHA MoE bf16": ["mha_decode_ctx"],
                "MHA MoE int8": ["mha_decode_ctx_int8", "quant_matmul_dyn_pre_q"],
                "MHA MoE int8 fat": ["mha_decode_ctx_int8"],
                "SwiGLU int8": ["ssm_decode_step_int8", "quant_matmul_dyn_pre_q"],
                "SwiGLU MHA int8": ["mha_decode_ctx_int8", "quant_matmul_dyn_pre_q"],
                "abs bf16": ["ffn_decode"], "abs int8": ["ffn_decode_int8"],
                "abs MHA bf16": ["mha_decode_ctx"], "abs MHA int8": ["mha_decode_ctx_int8"],
                "MM abs MHA bf16": ["mha_decode_ctx"],
                "MM abs MHA int8": ["mha_decode_ctx_int8"],
                "MHA Dh-48 int8": ["quant_matmul_dyn_pre_q"],
                "MHA Dh-320 int8": ["quant_matmul_dyn_pre_q"]
                }.get(kind, [])
        nl_small = small.num_hidden_layers
        # The mode's kernel: the prefill's six int8 linears a layer and the
        # head at prefill and at each of the 5 decode steps; the per-expert
        # kernel once per layer and decode step.
        exact = {"int8 pallas": {"quant_matmul": 6 * nl_small + 6, "quant_matmul_dyn_fused": 0,
                                 "quant_matmul_dyn_pre_q": 0, "ln_quantize": 0},
                 "int8 fused": {"quant_matmul_dyn_fused": 6 * nl_small + 6, "quant_matmul": 0,
                                "quant_matmul_dyn_pre_q": 0, "ln_quantize": 0},
                 "MoE int8 kernel": {"expert_ffn_dense": 5 * nl_small, "expert_ffn_fat": 0,
                                     "expert_ffn_grouped": 0},
                 # The decoder's pre-norms (two a layer, the MoE mixer's
                 # one), then ln1 and ln2 of each ViT layer, once a prefill.
                 "MM int8": {"ln_quantize": 2 * nl_small + 2 * small.vision_layers},
                 "MM MoE int8": {"ln_quantize": nl_small + 2 * small.vision_layers},
                 # The MHA FFN's pre-norm once a layer at prefill (decode
                 # quantizes its normed rows apart), then the ViT's norms;
                 # #9 once a layer and decode step.
                 "MM MHA int8": {"ln_quantize": nl_small + 2 * small.vision_layers,
                                 "mha_decode_ctx_int8": 5 * nl_small},
                 "MM MHA bf16": {"mha_decode_ctx": 5 * nl_small},
                 # MHA + MoE: request A's 4 x 45 rows through the grouped
                 # kernel (past 64), each decode step's 4 through the fat
                 # kernel, or under fat through its products in plain torch.
                 "MHA MoE bf16": {"expert_ffn_fat": 5 * nl_small,
                                  "expert_ffn_grouped": nl_small},
                 "MHA MoE int8": {"expert_ffn_fat": 5 * nl_small,
                                  "expert_ffn_grouped": nl_small},
                 "MHA MoE int8 fat": {"expert_ffn_fat": 0, "expert_ffn_grouped": nl_small},
                 # top-1 and top-3: every decode step without the moe
                 # epilogue (top-2 only), then the fat kernel.
                 "top-1 MoE bf16": {"expert_ffn_fat": 5 * nl_small,
                                    "ssm_decode_step": 5 * nl_small},
                 "top-1 MoE int8": {"expert_ffn_fat": 5 * nl_small,
                                    "ssm_decode_step_int8": 5 * nl_small},
                 "top-3 MoE bf16": {"expert_ffn_fat": 5 * nl_small,
                                    "ssm_decode_step": 5 * nl_small},
                 "top-3 MoE int8": {"expert_ffn_fat": 5 * nl_small,
                                    "ssm_decode_step_int8": 5 * nl_small},
                 # SwiGLU: no decode FFN kernel; its pre-norm's #5 feeds
                 # w_gate and w_up at prefill, after the mixer's.
                 "SwiGLU bf16": {"ffn_decode": 0},
                 "SwiGLU int8": {"ffn_decode_int8": 0, "ln_quantize": 2 * nl_small},
                 "SwiGLU MHA int8": {"ffn_decode_int8": 0, "ln_quantize": nl_small},
                 # Heads of 48 and 320: the plain decode attention.
                 **{f"MHA Dh-{w} {t}": {"mha_decode_ctx": 0, "mha_decode_ctx_int8": 0}
                    for w in (48, 320) for t in ("bf16", "int8")},
                 }.get(kind, {})
        if any(name not in ran for name in must) or (
                kind == "hidden-192 int8" and "ffn_decode_int8" in ran) or any(
                ran.get(name, 0) != n for name, n in exact.items()):
            raise RuntimeError(f"2-layer {kind}: kernels launched {ran}, expected {must} "
                               f"and {exact}")
        log(f"  2-layer {kind} on the card launched {ran}")

    # The 40-expert int8 model through InferenceEngine.generate on the card:
    # request A (bucketed prefill through the grouped kernel), every decode
    # step without the moe epilogue (the model asks the step for no router)
    # and then the fat kernel, once a layer and step.
    small = ApertisConfig(**moe40_small)
    tree = init_params(small, torch.Generator().manual_seed(SEED), device="cpu",
                       dtype=torch.bfloat16)
    perturb_(tree, torch.Generator().manual_seed(SEED + 3))
    m40 = from_jax_params(quantize_params(tree, min_size=0), small, device=dev,
                          dtype=torch.bfloat16)
    engine = InferenceEngine(small, m40, quant_matmul="dyn")
    routers, real_step = [], apertis_model.ssm_decode_step

    def step_spy(*a, **kw):
        routers.append(kw.get("router") is not None)
        return real_step(*a, **kw)

    apertis_model.ssm_decode_step = step_spy
    for f in counters:
        f.launches = 0
    try:
        out40 = engine.generate(batch_a % 1000, attention_mask=mask_a, max_new_tokens=8,
                                eos_token_id=())
    finally:
        apertis_model.ssm_decode_step = real_step
    steps40 = out40.shape[1] - batch_a.shape[1] - 1
    nl40 = small.num_hidden_layers
    ran = {f.__name__: f.launches for f in counters if f.launches}
    if (out40.shape != (4, batch_a.shape[1] + 8) or out40[:, batch_a.shape[1]:].min() < 0
            or out40[:, batch_a.shape[1]:].max() >= small.vocab_size
            or len(routers) != nl40 * steps40 or any(routers)
            or ran.get("expert_ffn_fat") != nl40 * steps40
            or ran.get("ssm_decode_step_int8") != nl40 * steps40):
        raise RuntimeError(f"2-layer 40-expert int8 generate: output {out40.shape}, epilogue "
                           f"asked {sum(routers)} of {len(routers)} steps, launched {ran}")
    log(f"  2-layer 40-expert int8 model through InferenceEngine.generate on the card: "
        f"{steps40 + 1} new tokens, {len(routers)} decode steps without the moe epilogue, "
        f"launched {ran}")
    del m40, engine

    # An f32 flash MHA forward() on the card runs the f32 flash kernel once
    # per layer (never the bf16 one), and agrees with the same forward() on
    # the CPU.
    small = ApertisConfig(**dict(mha_small, use_flash_attention=True, dtype="float32",
                                 param_dtype="float32"))
    tree = init_params(small, torch.Generator().manual_seed(SEED), device="cpu")
    perturb_(tree, torch.Generator().manual_seed(SEED + 3))
    ids_f32 = torch.as_tensor(np.random.default_rng(SEED + 12).integers(4, 1000, (2, 256)))
    flash_attention_fwd.launches = flash_attention_fwd_f32.launches = 0
    with torch.no_grad():
        got = from_jax_params(tree, small, device=dev)(ids_f32.to(dev))
        torch.cuda.synchronize()
        ref = from_jax_params(tree, small, device="cpu")(ids_f32)
    f32_flash_err = compare("2-layer f32 flash MHA forward() on the card (f32 flash kernel) vs "
                            "the CPU", got.cpu(), ref, F32_FORWARD_TOL)
    if (flash_attention_fwd_f32.launches != small.num_hidden_layers
            or flash_attention_fwd.launches != 0):
        raise RuntimeError(f"an f32 forward() launched the f32 flash kernel "
                           f"{flash_attention_fwd_f32.launches} times and the bf16 one "
                           f"{flash_attention_fwd.launches} times")
    launches["flash_attention_fwd_f32"] = flash_attention_fwd_f32.launches
    log(f"  2-layer f32 flash MHA forward(): flash_attention_fwd_f32 launched "
        f"{flash_attention_fwd_f32.launches} times, the bf16 kernel never, ok")

    # A float MoE model's forward() with no engine computes its FFN in the
    # tree's dtype (moe_dense up to 64 tokens, moe_ragged above): no fat,
    # grouped or per-expert kernel launches, and it agrees with the CPU.
    small = ApertisConfig(**dict(moe_small, dtype="float32", param_dtype="float32"))
    tree = init_params(small, torch.Generator().manual_seed(SEED), device="cpu")
    perturb_(tree, torch.Generator().manual_seed(SEED + 13))
    expert_kernels = (expert_ffn_fat, expert_ffn_fat_int4, expert_ffn_grouped, expert_ffn_dense)
    for f in expert_kernels:
        f.launches = 0
    moe_forward_err = 0.0
    card_moe, cpu_moe = (from_jax_params(tree, small, device=where) for where in (dev, "cpu"))
    for width in (16, 256):       # 32 tokens: moe_dense; 512: moe_ragged
        with torch.no_grad():
            got = card_moe(ids_f32[:, :width].to(dev))
            ref = cpu_moe(ids_f32[:, :width])
        moe_forward_err = max(moe_forward_err, compare(
            f"2-layer f32 MoE forward() of 2 x {width} tokens on the card (no engine) vs the CPU",
            got.cpu(), ref, F32_FORWARD_TOL))
    if any(f.launches for f in expert_kernels):
        raise RuntimeError("a float MoE forward() with no engine launched an expert kernel: "
                           f"{ {f.__name__: f.launches for f in expert_kernels} }")
    log("  2-layer f32 MoE forward() with no engine: no fat, grouped or per-expert launch ok")
    del card_moe, cpu_moe

    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 6. train -------------------------------------------------------------
    from apertis_llm_torch.training import train_from_config
    from apertis_llm_torch.training import trainer as trainer_module
    from apertis_llm_torch.training.step import loss_fn
    from apertis_llm_torch.training.trainer import ApertisTrainer
    from apertis_llm_torch.utils.profiling import device_peak_tflops
    from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

    torch.cuda.empty_cache()
    # A host sync after every micro-step, so that the trainer's step timer
    # sees whole steps.
    os.environ["APERTIS_TRAINER_SYNC_EVERY"] = "1"
    train_counters = (selective_scan_fwd, selective_scan_bwd, selective_scan_bwd_smem,
                      flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
                      flash_attention_fwd_f32, flash_attention_dq_f32, flash_attention_dkv_f32,
                      expert_ffn_fat, expert_ffn_fat_int4, expert_ffn_grouped, expert_ffn_dense,
                      quant_matmul_dyn_pre_q)
    micro, accum, rows_, length = 8, 2, 4, 1024
    # bench.py's training batch: 4 x 1024 tokens. Eight micro-batches drawn
    # from the same four seeded sequences, so the loss falls within 4 updates.
    seqs = np.random.default_rng(SEED + 6).integers(4, config.vocab_size, (rows_, length))
    dataset = TokenRows([{"input_ids": seqs[i % rows_], "labels": seqs[i % rows_]}
                         for i in range(micro * rows_)], length)
    # Multimodal training: four seeded sequences of 512 text tokens, each
    # with its seeded (3, 224, 224) pixels, behind the ViT-B/16 prefix of 197
    # tokens: 709 positions.
    mm_length = 512
    mm_seqs = np.random.default_rng(SEED + 15).integers(4, config.vocab_size, (rows_, mm_length))
    mm_train_pixels = np.random.default_rng(SEED + 16).normal(
        size=(rows_, 3, 224, 224)).astype(np.float32)
    mm_dataset = TokenRows([{"input_ids": mm_seqs[i % rows_], "labels": mm_seqs[i % rows_],
                             "pixel_values": mm_train_pixels[i % rows_]}
                            for i in range(micro * rows_)], mm_length)
    train_perf = {}
    # The step metrics of each micro-step (the trainer logs what the JAX
    # trainer logs; lb_loss and rz_loss are read here).
    step_metrics = []
    real_train_step = trainer_module.train_step

    def recording_train_step(*a, **k):
        metrics = real_train_step(*a, **k)
        step_metrics.append(metrics)
        return metrics

    trainer_module.train_step = recording_train_step
    # The 1.5B MoE preset with its default MoE knobs: capacity factor 1.25,
    # noisy routing 0.1, expert dropout 0.1, lb 0.01, rz 0.001.
    flash_mha = dataclasses.replace(mha_config, use_flash_attention=True)
    for kind, cfg, bf16_compute, data in (
            ("dense SSM", config, True, dataset),
            ("MoE SSM", moe_config, True, dataset),
            ("MHA flash", flash_mha, True, dataset),
            ("MHA flash f32", flash_mha, False, dataset),
            ("dense SSM + ViT", dataclasses.replace(config, multimodal=True), True, mm_dataset),
            ("MHA flash + ViT", dataclasses.replace(flash_mha, multimodal=True), True,
             mm_dataset)):
        nl, seq_len = cfg.num_hidden_layers, data.max_length
        t0 = time.perf_counter()
        tree = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        trainer = ApertisTrainer(cfg, tree, data, output_dir="unused", batch_size=rows_,
                                 learning_rate=TRAIN_LR, num_epochs=1,
                                 gradient_accumulation_steps=accum, bf16=bf16_compute,
                                 use_gradient_checkpointing=True, seed=SEED, device=dev,
                                 save_checkpoints=False)
        del tree
        torch.cuda.synchronize()
        n_train = sum(p.numel() for p in trainer.model.parameters())
        behind = (f" text tokens behind {cfg.num_image_tokens} image tokens"
                  if cfg.multimodal else "")
        log(f"train {kind}: {n_train:,} f32 master parameters, trainer built in "
            f"{time.perf_counter() - t0:.1f} s; {micro} micro-batches of {rows_} x {seq_len}"
            f"{behind}, accumulation {accum}, remat, {'bf16' if bf16_compute else 'f32'} "
            f"compute, peak lr {TRAIN_LR}")
        for f in train_counters:
            f.launches = 0
        step_metrics.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {f.__name__: f.launches for f in train_counters}
        expected = {f.__name__: 0 for f in train_counters}
        if cfg.attention_type == "standard_mha" and bf16_compute:
            expected.update(flash_attention_fwd=2 * nl * micro, flash_attention_dq=nl * micro,
                            flash_attention_dkv=nl * micro)
        elif cfg.attention_type == "standard_mha":
            expected.update(flash_attention_fwd_f32=2 * nl * micro,
                            flash_attention_dq_f32=nl * micro, flash_attention_dkv_f32=nl * micro)
        else:
            expected.update(selective_scan_fwd=2 * nl * micro, selective_scan_bwd=nl * micro)
        aux = torch.stack([torch.stack([m["lb_loss"], m["rz_loss"]])
                           for m in step_metrics]).cpu()
        moe = bool(cfg.use_expert_system)
        if len(step_metrics) != micro or not (
                torch.isfinite(aux).all() and ((aux > 0).all() if moe else (aux == 0).all())):
            raise RuntimeError(f"train {kind}: step lb_loss / rz_loss {aux.tolist()} are not "
                               f"{'finite and positive' if moe else 'zero'}")
        if moe:
            log(f"train {kind}: step lb_loss {[round(x, 5) for x in aux[:, 0].tolist()]}, "
                f"rz_loss {[round(x, 5) for x in aux[:, 1].tolist()]} (finite, positive)")
        log(f"train {kind} launch counts: {got} (expected {expected}: the forward twice per "
            "layer and micro-step under remat, the backward once, no expert kernel)")
        if got != expected:
            raise RuntimeError(f"train {kind}: a kernel of the training path was not launched "
                               "as expected")
        for key, value in got.items():
            launches[key] = launches.get(key, 0) + value
        losses = history["step_losses"]
        if history["final_step"] != micro // accum or len(losses) != micro:
            raise RuntimeError(f"train {kind}: {history['final_step']} updates, {len(losses)} "
                               "losses")
        if not (np.isfinite(losses).all() and np.mean(losses[-accum:]) < np.mean(losses[:accum])):
            raise RuntimeError(f"train {kind}: the loss is not finite or did not fall: {losses}")
        perf = history["perf"]
        p50 = perf["step_time_p50_s"]
        train_perf[kind] = dict(positions=seq_len + (cfg.num_image_tokens if cfg.multimodal
                                                     else 0),
                                step_ms_p50=p50 * 1e3, tokens_per_s=rows_ * seq_len / p50,
                                step_ms_wall=perf["step_time_wall_s"] * 1e3,
                                tokens_per_s_wall=perf["tokens_per_sec"],
                                mfu_pct=perf.get("mfu_pct"), wall_s=wall,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"train {kind}: losses {[round(x, 4) for x in losses]} (falls); micro-step p50 "
            f"{p50 * 1e3:.1f} ms = {rows_ * seq_len / p50:,.1f} tokens/s; epoch "
            f"{perf['step_time_wall_s'] * 1e3:.1f} ms a micro-step wall = "
            f"{perf['tokens_per_sec']:,.1f} tokens/s, MFU {perf.get('mfu_pct', 0):.1f} % of "
            f"{device_peak_tflops()} TFLOP/s; {wall:.1f} s in all, peak "
            f"{train_perf[kind]['peak_gb']:.1f} GB; card: {card}")
        del trainer
        torch.cuda.empty_cache()
    trainer_module.train_step = real_train_step

    # train_from_config on the card: a 2-layer SSM config, its checkpoint and
    # a resume from it.
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        vocab_path = work / "vocab.json"
        create_minimal_vocab_file(vocab_path, 64)
        words = sorted(json.loads(vocab_path.read_text()))
        text_rng = np.random.default_rng(SEED + 9)
        (work / "train.jsonl").write_text("".join(
            json.dumps({"text": " ".join(words[j] for j in text_rng.integers(4, 64, 48))}) + "\n"
            for _ in range(16)))

        def pipeline_config(name, **train):
            path = work / f"{name}.json"
            path.write_text(json.dumps({
                "data_config": {"train_data_path": str(work / "train.jsonl"),
                                "tokenizer_path": str(vocab_path), "max_length": 64},
                "model_config": {"target_param_count": "1M", "attention_type": "selective_ssm",
                                 "config_overrides": {
                                     "hidden_size": 256, "num_hidden_layers": 2,
                                     "num_attention_heads": 4, "intermediate_size": 1024,
                                     "hidden_dropout_prob": 0.1}},
                "training_config": dict({"output_dir": str(work / name), "batch_size": 4,
                                         "learning_rate": 1e-3, "num_epochs": 2,
                                         "gradient_accumulation_steps": 2, "device": "cuda"},
                                        **train)}))
            return str(path)

        for f in train_counters:
            f.launches = 0
        first = train_from_config(pipeline_config("run"))
        final = work / "run" / "final"
        files = sorted(p.name for p in final.iterdir())
        resumed = train_from_config(pipeline_config("resumed", num_epochs=1,
                                                    resume_from=str(final)))
        log(f"train_from_config: epoch losses {first['train_loss']}, {first['final_step']} "
            f"updates; final checkpoint {files}; resumed for an epoch: {resumed['final_step']} "
            f"updates; scan launches {selective_scan_fwd.launches} forward, "
            f"{selective_scan_bwd.launches} backward")
        if (first["final_step"] != 4 or resumed["final_step"] != 6
                or not {"state.pt", "pytorch_model.bin", "config.json", "vocab.json"} <= set(files)
                or not np.isfinite(first["train_loss"]).all()
                or first["train_loss"][-1] >= first["train_loss"][0]
                or selective_scan_bwd.launches != 2 * 12):
            raise RuntimeError("train_from_config on the card did not train, save or resume")

    # One train step's gradients of 2-layer models, card vs CPU. In bf16
    # compute (the SSM models, at d_state 16 and 12, and the flash MHA model)
    # each leaf is held to two bf16 ulps plus twice what bf16 itself does to
    # it (the CPU's bf16 vs f32 step); in f32 compute (the MoE model, with no
    # step seed: no noise or expert dropout, which the card's and the CPU's
    # generators would draw differently, and a capacity that drops tokens;
    # the f32 flash MHA model) to F32_GRAD_TOL.
    small_grad_err = {}
    ids_small = torch.as_tensor(np.random.default_rng(SEED + 8).integers(4, 1000, (2, 256)))
    dropped = []
    real_dispatch = moe_ops.moe_dispatch

    def dispatch(x, routing, experts, act, eps_, capacity, *rest):
        counts = torch.bincount(routing.indices.reshape(-1), minlength=experts["b2"].shape[0])
        dropped.append(int((counts - capacity).clamp(min=0).sum()))
        return real_dispatch(x, routing, experts, act, eps_, capacity, *rest)

    moe_ops.moe_dispatch = dispatch
    for family, kw, kernel, dtype in (
            ("SSM", dense_small, "selective_scan_bwd", torch.bfloat16),
            ("SSM d_state 12", dict(dense_small, ssm_d_state=12), "selective_scan_bwd_smem",
             torch.bfloat16),
            ("MHA flash", dict(mha_small, use_flash_attention=True), "flash_attention_dq",
             torch.bfloat16),
            ("MoE f32", moe_small, "selective_scan_bwd", None),
            ("MHA flash f32", dict(mha_small, use_flash_attention=True), "flash_attention_dq_f32",
             None),
            # The same behind the small image prefix (17 tokens, uint8
            # images resized on the device): the ViT's leaves too.
            ("MM SSM", dict(dense_small, **vit_small), "selective_scan_bwd", torch.bfloat16),
            ("MM MoE f32", dict(moe_small, **vit_small), "selective_scan_bwd", None),
            ("MM MHA flash", dict(mha_small, use_flash_attention=True, **vit_small),
             "flash_attention_dq", torch.bfloat16),
            ("MM MHA flash f32", dict(mha_small, use_flash_attention=True, **vit_small),
             "flash_attention_dq_f32", None)):
        small = ApertisConfig(**kw)
        tree = init_params(small, torch.Generator().manual_seed(SEED), device="cpu")
        perturb_(tree, torch.Generator().manual_seed(SEED + 7))
        results = {}
        for f in train_counters:
            f.launches = 0
        sides = [("card", dev, dtype), ("cpu", torch.device("cpu"), dtype)]
        if dtype is not None:
            sides.append(("cpu f32", torch.device("cpu"), None))
        dropped.clear()
        for side, where, compute in sides:
            m = from_jax_params(tree, small, device=where)
            params = dict(m.named_parameters())
            batch = {"input_ids": ids_small.to(where), "labels": ids_small.to(where)}
            if small.multimodal:
                batch["pixel_values"] = mm_pixels[:2].to(where)
            loss, _ = loss_fn(m, batch, None, compute)
            grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
            results[side] = (loss.detach().cpu(), {k: g.cpu() for k, g in zip(params, grads)})
            if side == "card":
                torch.cuda.synchronize()
                launched = {f.__name__: f.launches for f in train_counters}
        expect = {kernel: small.num_hidden_layers}
        if "MoE" in family:
            if not dropped or min(dropped) == 0:
                raise RuntimeError(f"2-layer {family}: the capacity dropped no pair ({dropped})")
            log(f"  2-layer {family}: moe_dispatch dropped {dropped} (token, choice) pairs a "
                "layer past the capacity")
        if any(launched.get(k, 0) != v for k, v in expect.items()) or any(
                launched[f.__name__] for f in expert_kernels):
            raise RuntimeError(f"2-layer {family}: kernels launched {launched}, expected {expect} "
                               "and no expert kernel")
        compare(f"2-layer {family} train-step loss on the card vs the CPU", results["card"][0],
                results["cpu"][0], BF16_ULP if dtype is not None else F32_FORWARD_TOL)
        # Per leaf, relative to its largest CPU element: the card's error,
        # bf16's own effect (the CPU's bf16 vs f32 runs) and the limit.
        leaves = []
        for name, ref in results["cpu"][1].items():
            got_g, scale = results["card"][1][name], float(ref.abs().max())
            if scale == 0.0:      # a leaf the step did not read (w_noise with no noise)
                if got_g.abs().max() != 0:
                    raise RuntimeError(f"2-layer {family} gradient {name}: zero on the CPU only")
                continue
            err = float((got_g - ref).abs().max()) / scale
            if dtype is None:
                floor, limit = 0.0, F32_GRAD_TOL
            else:
                floor = float((results["cpu f32"][1][name] - ref).abs().max()) / scale
                limit = SMALL_GRAD_TOL + 2 * floor
            if not (torch.isfinite(got_g).all() and err <= limit):
                raise RuntimeError(f"2-layer {family} gradient {name}: {err:.3e} of its largest "
                                   f"element on the card vs the CPU, limit {limit:.3e}")
            leaves.append((err / limit, name, err, floor, limit, scale))
        for key, value in launched.items():
            launches[key] = launches.get(key, 0) + value
        small_grad_err[family] = max(leaves)[0]
        rule = (f"within {SMALL_GRAD_TOL:.3e} + 2 x (bf16 vs f32 compute on the CPU)"
                if dtype is not None else f"within {F32_GRAD_TOL:.0e}")
        log(f"  2-layer {family} train step, card vs CPU: {len(leaves)} gradient leaves ok, each "
            f"{rule} of its largest element; {kernel} launched {launched[kernel]} times ok")
        for ratio, name, err, floor, limit, scale in ([max(leaves)]
                                                      + sorted(leaves, key=lambda t: -t[2])[:3]):
            own = f", bf16 vs f32 on the CPU {floor:.3e}" if dtype is not None else ""
            log(f"    {name} (largest element {scale:.3e}): card vs CPU {err:.3e}{own}, limit "
                f"{limit:.3e} ({ratio:.3f} of it)")
    moe_ops.moe_dispatch = real_dispatch

    # ---- 6b. checkpoint round trip -------------------------------------------
    # The 1.5B MHA preset's widths with the ViT-B/16 prefix, cut to 2 decoder
    # layers so that the file stays near 1.5 GB of f32, in bf16 on the card
    # from a seeded noisy tree: exported with save_torch_checkpoint, then
    # loaded with load_pretrained on the card (its default device) from the
    # directory with config.json, and from the weights file alone, whose
    # config is read off its shapes. forward()'s logits with images must be
    # bit-equal to the writer's, and a greedy generate with images must give
    # the writer's tokens. (The tests load every family from either
    # package's files on the CPU; an SSM model read from a bare file keeps
    # the default f32 conv cache, since the shapes do not give
    # config.dtype.)
    ckpt_ids = np.random.default_rng(SEED + 18).integers(4, config.vocab_size, (2, 40))
    ckpt_images = next(iter(images.values()))[:2]
    ids_t = torch.as_tensor(ckpt_ids, device=dev)
    img_t = torch.as_tensor(ckpt_images, device=dev)
    round_trip = {}
    for family, cfg in (("MHA + ViT", mha_config),):
        wcfg = dataclasses.replace(cfg, num_hidden_layers=2, multimodal=True)
        tree = init_params(wcfg, torch.Generator(device=dev).manual_seed(SEED + 19), device=dev,
                           dtype=bf16)
        perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 20))
        writer = from_jax_params(tree, wcfg, device=dev, dtype=bf16)
        del tree
        gen_kw = dict(pixel_values=ckpt_images, max_new_tokens=8, eos_token_id=())
        with torch.no_grad():
            ref_logits = writer(ids_t, pixel_values=img_t)
        ref_tokens = InferenceEngine(wcfg, writer).generate(ckpt_ids, **gen_kw)
        with tempfile.TemporaryDirectory() as work:
            work = Path(work)
            t0 = time.perf_counter()
            save_torch_checkpoint(params_tree(writer), wcfg, work / "ckpt")
            saved_s = time.perf_counter() - t0
            file_bytes = (work / "ckpt" / "pytorch_model.bin").stat().st_size
            results = {"file_bytes": file_bytes, "save_s": saved_s}
            for way in ("config.json", "bare weights file"):
                path = work / "ckpt"
                if way != "config.json":
                    (work / "bare").mkdir()
                    path = work / "bare" / "weights.bin"
                    os.replace(work / "ckpt" / "pytorch_model.bin", path)
                t0 = time.perf_counter()
                loaded = load_pretrained(path, dtype=bf16)
                load_s = time.perf_counter() - t0
                if loaded.device.type != "cuda":
                    raise RuntimeError(f"{family}: load_pretrained built on {loaded.device}")
                with torch.no_grad():
                    same_logits = torch.equal(loaded(ids_t, pixel_values=img_t), ref_logits)
                tokens = InferenceEngine(loaded.config, loaded).generate(ckpt_ids, **gen_kw)
                same_tokens = bool(np.array_equal(tokens, ref_tokens))
                results[way] = dict(logits_bit_equal=same_logits, tokens_equal=same_tokens,
                                    load_s=load_s)
                log(f"checkpoint round trip {family} (2 layers, {file_bytes:,} bytes, saved in "
                    f"{saved_s:.1f} s), {way}: loaded on {loaded.device} in {load_s:.1f} s, "
                    f"logits bit-equal {same_logits}, greedy tokens with images equal to the "
                    f"writer's {same_tokens}")
                if not (same_logits and same_tokens):
                    raise RuntimeError(f"{family}: the {way} checkpoint does not give the "
                                       "writer's logits and tokens")
                del loaded
        round_trip[family] = results
        del writer
        torch.cuda.empty_cache()
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 7. data- and sequence-parallel training: two ranks on the card -------
    # NCCL does not put two ranks on one card, so the two ranks share it in a
    # gloo process group, which passes the CUDA tensors through the host.
    from apertis_llm_torch.ops.ssm import selective_scan
    from apertis_llm_torch.parallel import spawn

    log("data- and sequence-parallel training: two ranks sharing the card over gloo")
    # The references, in this process on the card: one-rank selective_scan
    # over the whole sequence (the 1.5B training shape), a 2-layer f32
    # dense-SSM train step, and the 1.5B preset's run on mesh (1, 1, 1, 1).
    srng = np.random.default_rng(SEED + 13)
    sshape = (4, ssm_heads, 1024, n)
    scan_args = (srng.uniform(0.4, 0.999, sshape).astype(np.float32),
                 srng.normal(size=sshape).astype(np.float32),
                 srng.normal(size=(4, ssm_heads, n)).astype(np.float32))
    at, bt = (torch.tensor(x, device=dev, requires_grad=True) for x in scan_args[:2])
    h_ref, h_last_ref = selective_scan(at, bt)
    w_ref = torch.as_tensor(scan_args[2], device=dev)
    scan_ref = (h_ref.detach(), h_last_ref.detach()) + torch.autograd.grad(
        (h_ref ** 2).sum() + 2 * (h_last_ref * w_ref).sum(), (at, bt))
    small_cfg = ApertisConfig(**dense_small)
    tree = init_params(small_cfg, torch.Generator().manual_seed(SEED), device="cpu")
    perturb_(tree, torch.Generator().manual_seed(SEED + 7))
    small_tree = to_numpy(tree)
    ids_mesh = np.random.default_rng(SEED + 14).integers(4, 1000, (4, 256))
    m = from_jax_params(small_tree, small_cfg, device=dev)
    params = dict(m.named_parameters())
    ids_t = torch.as_tensor(ids_mesh, device=dev)
    loss, _ = loss_fn(m, {"input_ids": ids_t, "labels": ids_t}, None)
    small_ref = (loss.detach().cpu(), {k: g_.cpu() for k, g_ in zip(
        params, torch.autograd.grad(loss, list(params.values())))})
    del m, params, loss, at, bt, h_ref, h_last_ref
    # The 1.5B preset: 4 micro-steps of the global 4 x 1024 batch (2 updates).
    # Its first update runs at the one-cycle schedule's start, lr / 25, and is
    # the only one before the last loss: a peak of PARALLEL_LR makes that
    # update move the loss well past the batches' spread.
    par_micro = 4
    trainer_kw = dict(output_dir="unused", batch_size=rows_, learning_rate=PARALLEL_LR,
                      num_epochs=1, gradient_accumulation_steps=accum, bf16=True,
                      use_gradient_checkpointing=True, seed=SEED, save_checkpoints=False)
    par_dataset = TokenRows([{"input_ids": seqs[i % rows_], "labels": seqs[i % rows_]}
                             for i in range(par_micro * rows_)], length)
    tree = init_params(config, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    trainer = ApertisTrainer(config, tree, par_dataset, device=dev, **trainer_kw)
    del tree
    one_rank = trainer.train()
    del trainer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  one process, mesh (1, 1, 1, 1): losses {one_rank['step_losses']}; this process "
        f"holds {torch.cuda.memory_allocated() / 1e9:.2f} GB while the ranks run")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks = spawn(parallel_rank, 2, work, (
            scan_args, (dense_small, small_tree, ids_mesh),
            (config, seqs, par_micro, trainer_kw)), timeout=600)
    log(f"  two ranks spawned, ran and joined in {time.perf_counter() - t0:.1f} s")

    # The sequence-parallel scan against the one-rank scan.
    got = [torch.cat([r["scan"][i] for r in ranks], dim=2) for i in (0, 2, 3)]
    compare("two-rank SP scan h vs one rank", got[0], scan_ref[0].cpu(), CARRY_TOL)
    for i, r in enumerate(ranks):
        compare(f"two-rank SP scan h_last (rank {i}) vs one rank", r["scan"][1],
                scan_ref[1].cpu(), CARRY_TOL)
    compare("two-rank SP scan da vs one rank", got[1], scan_ref[2].cpu(), CARRY_BWD_TOL)
    compare("two-rank SP scan db vs one rank", got[2], scan_ref[3].cpu(), CARRY_BWD_TOL)
    # The 2-layer f32 train step on each mesh against one process.
    for shape in ((1, 1, 1, 2), (2, 1, 1, 1)):
        (l0, g0, d0), (l1, _, d1) = ranks[0]["small"][shape], ranks[1]["small"][shape]
        compare(f"2-layer f32 train-step loss on mesh {shape} vs one process",
                torch.tensor(l0), small_ref[0], F32_SP_LOSS_TOL)
        if l0 != l1:
            raise RuntimeError(f"mesh {shape}: the ranks hold other losses ({l0}, {l1})")
        worst = max(float((g0[k] - ref).abs().max()) / float(ref.abs().max())
                    for k, ref in small_ref[1].items())
        if worst > F32_GRAD_TOL:
            raise RuntimeError(f"mesh {shape}: a gradient is {worst:.3e} of its largest element "
                               f"off the one-process step, limit {F32_GRAD_TOL:.0e}")
        if d0 != d1:
            raise RuntimeError(f"mesh {shape}: the ranks' parameters differ after two updates")
        log(f"  2-layer f32 mesh {shape}: {len(g0)} gradient leaves within {worst:.3e} of their "
            f"largest element of one process (limit {F32_GRAD_TOL:.0e}); after two updates "
            f"both ranks' parameters hash to {d0[:16]} ok")
    # The 1.5B preset on mesh (1, 1, 1, 2).
    nl = config.num_hidden_layers
    expected = {"selective_scan_carry_fwd": nl * 2 * par_micro * 2,
                "selective_scan_carry_bwd": nl * 2 * par_micro,
                "selective_scan_fwd": 0, "selective_scan_bwd": 0}
    for i, r in enumerate(ranks):
        pre = r["preset"]
        log(f"  1.5B rank {i}: launches {pre['launches']} (expected {expected}: 2 scans a layer, "
            f"the forward twice under remat); losses {pre['losses']}; micro-step p50 "
            f"{pre['p50_s'] * 1e3:.1f} ms; gradient all-reduce {pre['reduce_ms']} ms; peak "
            f"{pre['peak_gb']:.2f} GB")
        if pre["launches"] != expected:
            raise RuntimeError(f"1.5B rank {i}: the scan kernels were not launched as expected")
        if pre["losses"] != ranks[0]["preset"]["losses"] or pre["final_step"] != par_micro // accum:
            raise RuntimeError("1.5B: the ranks' histories differ or the updates are missing")
    pre = ranks[0]["preset"]
    losses = pre["losses"]
    compare("1.5B first micro-step loss, mesh (1, 1, 1, 2) vs one process",
            torch.tensor(losses[0]), torch.tensor(one_rank["step_losses"][0]), BF16_ULP)
    if not (np.isfinite(losses).all() and np.mean(losses[accum:]) < np.mean(losses[:accum])):
        raise RuntimeError(f"1.5B on mesh (1, 1, 1, 2): the loss is not finite or did not fall: "
                           f"{losses}")
    reduce_share = [sum(r["preset"]["reduce_ms"]) / 1e3 / r["preset"]["wall_s"] for r in ranks]
    for key in expected:
        launches[key] = launches.get(key, 0) + sum(r["preset"]["launches"][key] for r in ranks)
    train_perf["dense SSM mesh (1, 1, 1, 2)"] = dict(
        step_ms_p50=pre["p50_s"] * 1e3, tokens_per_s=rows_ * length / pre["p50_s"],
        wall_s=pre["wall_s"], allreduce_ms=pre["reduce_ms"],
        allreduce_share=reduce_share, allreduce_gb=pre["grad_bytes"] / 1e9,
        peak_gb_per_rank=[r["preset"]["peak_gb"] for r in ranks],
        losses=losses, one_process_losses=one_rank["step_losses"])
    log(f"  1.5B on mesh (1, 1, 1, 2): losses {[round(x, 4) for x in losses]} (falls; one "
        f"process {[round(x, 4) for x in one_rank['step_losses']]}); micro-step p50 "
        f"{pre['p50_s'] * 1e3:.1f} ms = {rows_ * length / pre['p50_s']:,.1f} tokens/s; the "
        f"gradient all-reduce ({pre['grad_bytes'] / 1e9:.2f} GB of f32 a micro-step) "
        f"{np.median(pre['reduce_ms']):.1f} ms at the median, {reduce_share[0] * 100:.1f} % "
        f"of rank 0's training time; peak {[round(r['preset']['peak_gb'], 2) for r in ranks]}"
        f" GB per rank; card: {card}")
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 8. the surfaces: CLI chat, eval and fine-tuning, the UI backend --------
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        surface_launches, surfaces = surfaces_phase(card, dev, work)
    for name in F32_FORMS:
        if not surface_launches.get(name):
            raise RuntimeError(f"phase 8: {name} was not launched")
        launches[name] = surface_launches[name]
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # ---- report -------------------------------------------------------------
    replaces = {
        "selective_scan_fwd": ("apertis_llm_torch/csrc/ssm_scan.cu",
                               "apertis_llm_tpu/ops/pallas/ssm_scan.py:327"),
        "ssm_decode_step": ("apertis_llm_torch/csrc/ssm_step.cu",
                            "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
        "ssm_decode_step_int8": ("apertis_llm_torch/csrc/ssm_step.cu",
                                 "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
        "ffn_decode": ("apertis_llm_torch/csrc/ffn_fused.cu",
                       "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
        "ffn_decode_int8": ("apertis_llm_torch/csrc/ffn_fused.cu",
                            "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
        "ln_quantize": ("apertis_llm_torch/csrc/ln_quant.cu",
                        "apertis_llm_tpu/ops/pallas/ln_quant.py:60"),
        "ssm_decode_step_moe": ("apertis_llm_torch/csrc/ssm_step.cu",
                                "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
        "ssm_decode_step_int8_moe": ("apertis_llm_torch/csrc/ssm_step.cu",
                                     "apertis_llm_tpu/ops/pallas/ssm_step.py:234"),
        "expert_ffn_fat": ("apertis_llm_torch/csrc/moe_ffn.cu",
                           "apertis_llm_tpu/ops/pallas/moe_ffn.py:243"),
        "expert_ffn_grouped": ("apertis_llm_torch/csrc/moe_grouped.cu",
                               "apertis_llm_tpu/ops/pallas/moe_grouped.py:76"),
        "mha_decode_ctx": ("apertis_llm_torch/csrc/mha_step.cu",
                           "apertis_llm_tpu/ops/pallas/mha_step.py:131"),
        "mha_decode_ctx_int8": ("apertis_llm_torch/csrc/mha_step.cu",
                                "apertis_llm_tpu/ops/pallas/mha_step.py:131"),
        "flash_attention_fwd": ("apertis_llm_torch/csrc/flash_attention.cu",
                                "apertis_llm_tpu/ops/pallas/flash_attention.py:208"),
        "selective_scan_bwd": ("apertis_llm_torch/csrc/ssm_scan.cu",
                               "apertis_llm_tpu/ops/pallas/ssm_scan.py:302"),
        "flash_attention_dq": ("apertis_llm_torch/csrc/flash_attention_bwd.cu",
                               "apertis_llm_tpu/ops/pallas/flash_attention.py:257"),
        "flash_attention_dkv": ("apertis_llm_torch/csrc/flash_attention_bwd.cu",
                                "apertis_llm_tpu/ops/pallas/flash_attention.py:282"),
        "quant_matmul_dyn_pre_q": ("apertis_llm_torch/csrc/quant_matmul.cu",
                                   "apertis_llm_tpu/ops/pallas/quant_matmul.py:160"),
        "ffn_decode_int4": ("apertis_llm_torch/csrc/ffn_fused.cu",
                            "apertis_llm_tpu/ops/pallas/ffn_fused.py:177"),
        "expert_ffn_fat_int4": ("apertis_llm_torch/csrc/moe_ffn.cu",
                                "apertis_llm_tpu/ops/pallas/moe_ffn.py:243"),
        "quant_matmul": ("apertis_llm_torch/csrc/quant_matmul.cu",
                         "apertis_llm_tpu/ops/pallas/quant_matmul.py:201"),
        "quant_matmul_dyn_fused": ("apertis_llm_torch/csrc/quant_matmul.cu",
                                   "apertis_llm_tpu/ops/pallas/quant_matmul.py:301"),
        "expert_ffn_dense": ("apertis_llm_torch/csrc/moe_dense.cu",
                             "apertis_llm_tpu/ops/pallas/moe_ffn.py:399"),
        "selective_scan_bwd_smem": ("apertis_llm_torch/csrc/ssm_scan.cu",
                                    "apertis_llm_tpu/ops/pallas/ssm_scan.py:302"),
        "flash_attention_fwd_f32": ("apertis_llm_torch/csrc/flash_attention_f32.cu",
                                    "apertis_llm_tpu/ops/pallas/flash_attention.py:208"),
        "flash_attention_dq_f32": ("apertis_llm_torch/csrc/flash_attention_f32.cu",
                                   "apertis_llm_tpu/ops/pallas/flash_attention.py:257"),
        "flash_attention_dkv_f32": ("apertis_llm_torch/csrc/flash_attention_f32.cu",
                                    "apertis_llm_tpu/ops/pallas/flash_attention.py:282"),
        "selective_scan_carry_fwd": ("apertis_llm_torch/csrc/scan_carry.cu",
                                     "apertis_llm_tpu/ops/pallas/ssm_scan.py:184"),
        "selective_scan_carry_bwd": ("apertis_llm_torch/csrc/scan_carry.cu",
                                     "apertis_llm_tpu/ops/pallas/ssm_scan.py:184"),
        **{name: F32_FORMS[name] for name in F32_FORMS},
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        ms, plain_ms, bound_ms, bound_by, dev_ms = times[name]
        # No single PyTorch call computes the other functions (a norm fused
        # with a per-row int8 quantize, a whole mixer step, a whole FFN, a selective scan, an int8
        # expert FFN with per-tile or per-row requantization, attention over
        # an int8 cache with per-(head, slot) scales, an int8 product whose
        # activations are quantized per 512-wide block): their library time
        # is null.
        cold = decode.get(f"{name} at 64 rows", {})
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": tpu,
                        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library.get(name),
                        "library_colmajor_ms": library_cols.get(name),
                        "cold_ms": cold.get("cold_ms"),
                        "cold_device_ms": cold.get("cold_device_ms"),
                        "other_shapes": shape_times.get(name, {})})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"flash_resources": flash_resources}))
    print(json.dumps({"qmm": qmm}))
    print(json.dumps({"decode_times": decode, "decode_resources": decode_resources,
                      "ln_resources": ln_resources}))
    print(json.dumps({"kernels": kernels, "serve": serve, "train": train_perf,
                      "small_model_max_abs_err": small_err,
                      "small_train_grad_err_over_limit": small_grad_err,
                      "flash_forward_max_abs_err": flash_forward_err,
                      "f32_flash_forward_max_abs_err": f32_flash_err,
                      "moe_f32_forward_max_abs_err": moe_forward_err,
                      "scan_carry_bit_equal": carry_bit_equal,
                      "checkpoint_round_trip": round_trip,
                      "ln_quantize_bit_equal": ln_bit_equal,
                      "moe_epilogue_seeds": fault2,
                      "mha_moe_fat_vs_fatk": fat_vs_fatk, "surfaces": surfaces}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def qmm_main(check: bool) -> int:
    """``--qmm``: the int8-weight GEMM phase alone (checks, repeats,
    resources, times, and the times of other tile plans);
    ``--qmm-times``: its times alone, which a checkout of an earlier commit
    can run with this script copied into it."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.ops.kernels import _build
    card = card_line()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"card: {card}; build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for section in lib_path.with_suffix(".log").read_text().split("== ")[1:]:
        if section.startswith(("quant_matmul.cu", "mha_step.cu")):
            for line in section.splitlines():
                if any(w in line for w in ("==", "Compiling entry", "registers", "spill",
                                           "arning", "rror")):
                    log(f"  nvcc {line.strip()}")
    result = qmm_phase(card, check=check, alternatives=check)
    print(json.dumps({"qmm": result}))
    print(card)
    return 0


def flash_f32_times_main() -> int:
    """``--flash-f32-times``: the f32 flash kernels' times at the 1.5B MHA
    model's training shape (4, 38, 1024, 64) beside scaled_dot_product_attention
    in f32 (TF32 off), and the micro-step p50 of that model trained in f32
    compute through them (phase 6's "MHA flash f32" run: 8 micro-batches of
    4 x 1024, accumulation 2, remat). It needs nothing of the checkout but the
    wrappers' and the trainer's Python interface, so a checkout of an earlier
    commit can run it with this script copied into it, for a comparison in
    one call."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.ops.kernels import _build
    from apertis_llm_torch.ops.kernels.flash_attention import (
        flash_attention_dkv_f32, flash_attention_dq_f32, flash_attention_fwd_f32)
    from apertis_llm_torch.training.trainer import ApertisTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"card: {card}; build in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (4, 38, 1024, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    out, lse = flash_attention_fwd_f32(q, k, v)
    delta = (out * do).sum(dim=-1)
    result = {}
    for name, fn, args, products in (
            ("flash_attention_fwd_f32", flash_attention_fwd_f32, (q, k, v), 2),
            ("flash_attention_dq_f32", flash_attention_dq_f32, (q, k, v, do, lse, delta), 3),
            ("flash_attention_dkv_f32", flash_attention_dkv_f32, (q, k, v, do, lse, delta), 4)):
        result[name] = dict(ms=cuda_ms(lambda: fn(*args)), device_ms=device_ms(lambda: fn(*args)),
                            bound_ms=bound(*f32_flash_cost(shape, products))[0])
    result["sdpa_f32_ms"], result["sdpa_f32_bwd_ms"] = sdpa_f32_ms((q, k, v), do)
    log(f"f32 flash at {shape}: {json.dumps(result)}; card: {card}")
    del q, k, v, do, out, lse, delta

    cfg = dataclasses.replace(mha_preset_config(calculate_model_dimensions("1.5B", 32000)),
                              use_flash_attention=True)
    micro, accum, rows, length = 8, 2, 4, 1024
    seqs = np.random.default_rng(SEED + 6).integers(4, cfg.vocab_size, (rows, length))
    dataset = TokenRows([{"input_ids": seqs[i % rows], "labels": seqs[i % rows]}
                         for i in range(micro * rows)], length)
    os.environ["APERTIS_TRAINER_SYNC_EVERY"] = "1"
    tree = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    trainer = ApertisTrainer(cfg, tree, dataset, output_dir="unused", batch_size=rows,
                             learning_rate=TRAIN_LR, num_epochs=1,
                             gradient_accumulation_steps=accum, bf16=False,
                             use_gradient_checkpointing=True, seed=SEED, device=dev,
                             save_checkpoints=False)
    del tree
    for f in (flash_attention_fwd_f32, flash_attention_dq_f32, flash_attention_dkv_f32):
        f.launches = 0
    history = trainer.train()
    torch.cuda.synchronize()
    losses = history["step_losses"]
    result["mha_flash_f32_step_ms_p50"] = history["perf"]["step_time_p50_s"] * 1e3
    result["mha_flash_f32_losses"] = losses
    result["launches"] = {f.__name__: f.launches for f in (
        flash_attention_fwd_f32, flash_attention_dq_f32, flash_attention_dkv_f32)}
    if not (np.isfinite(losses).all() and np.mean(losses[-accum:]) < np.mean(losses[:accum])):
        raise RuntimeError(f"MHA flash f32: the loss is not finite or did not fall: {losses}")
    print(json.dumps({"flash_f32_times": result}))
    print(card)
    return 0


def decode_times_main() -> int:
    """``--decode-times``: decode_times on the 1.5B int8 and bf16 models,
    moe_step_times on the 1.5B int8 and bf16 MoE models, fat_times and
    dense_times on the 1.5B int8 MoE model, and fat_times
    on COLD_INT4_LAYERS layers of the 3B MoE model with int4 fat stacks
    alone (each built as the full run builds it), which a checkout of an
    earlier commit can run with this script copied into it, for a
    comparison in one call."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.models.convert import from_jax_params
    from apertis_llm_torch.models.factory import calculate_model_dimensions
    from apertis_llm_torch.models.params import init_params
    from apertis_llm_torch.models.quantize import quantize_params
    from apertis_llm_torch.ops.kernels import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"card: {card}; build in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    config = dense_preset_config(calculate_model_dimensions("1.5B", 32000))
    tree = init_params(config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=torch.bfloat16)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 2))
    model = from_jax_params(tree, config, device=dev, dtype=torch.bfloat16)
    qtree = quantize_params(tree)
    del tree
    qmodel = from_jax_params(qtree, config, device=dev, dtype=torch.bfloat16)
    del qtree
    result = decode_times(card, qmodel, config, model)
    del qmodel, model
    moe_config = moe_preset_config(
        calculate_model_dimensions("1.5B", 32000, use_expert_system=True))
    tree = init_params(moe_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=torch.bfloat16)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 4))
    moe_model = from_jax_params(tree, moe_config, device=dev, dtype=torch.bfloat16)
    qtree = quantize_params(tree)
    del tree
    moe_qmodel = from_jax_params(qtree, moe_config, device=dev, dtype=torch.bfloat16)
    del qtree
    result.update(moe_step_times(card, moe_qmodel, moe_config, moe_model))
    del moe_model
    moe_qmodel.attach_moe_fat()
    result.update(fat_times(card, moe_qmodel, moe_config))
    result.update(dense_times(card, moe_qmodel, moe_config))
    del moe_qmodel
    # The 3B MoE preset, cut to the layers the int4 cold time rotates over.
    m3dims = calculate_model_dimensions("3B", 32000, use_expert_system=True)
    moe3_config = dataclasses.replace(
        moe_config, hidden_size=m3dims["hidden_size"], num_hidden_layers=COLD_INT4_LAYERS,
        num_attention_heads=m3dims["num_attention_heads"],
        intermediate_size=m3dims["intermediate_size"])
    tree = init_params(moe3_config, torch.Generator(device=dev).manual_seed(SEED), device=dev,
                       dtype=torch.bfloat16)
    perturb_(tree, torch.Generator(device=dev).manual_seed(SEED + 10))
    qtree = quantize_params(tree)
    del tree
    moe3_model = from_jax_params(qtree, moe3_config, device=dev, dtype=torch.bfloat16)
    del qtree
    moe3_model.attach_moe_fat(bits=4)
    result.update(fat_times(card, moe3_model, moe3_config))
    print(json.dumps({"decode_times": result}))
    print(card)
    return 0


def times_main(key, times) -> int:
    """A timing mode alone (``--scan-fwd-times``: scan_fwd_times;
    ``--scan-bwd-times``: scan_bwd_times; ``--grouped-times``:
    grouped_times; ``--ln-times``: ln_times): the kernels' build, then
    ``times(card)`` printed under ``key``."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    from apertis_llm_torch.ops.kernels import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"card: {card}; build in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({key: times(card)}))
    print(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--scan-fwd-times"]:
        sys.exit(times_main("scan_fwd_times", scan_fwd_times))
    if sys.argv[1:] == ["--scan-bwd-times"]:
        sys.exit(times_main("scan_bwd_times", scan_bwd_times))
    if sys.argv[1:] == ["--grouped-times"]:
        sys.exit(times_main("grouped_times", grouped_times))
    if sys.argv[1:] == ["--ln-times"]:
        sys.exit(times_main("ln_times", ln_times))
    if sys.argv[1:] == ["--auto-times"]:
        sys.exit(times_main("auto_times", auto_times))
    if sys.argv[1:] == ["--auto-model-times"]:
        sys.exit(times_main("auto_model_times", auto_model_times))
    if sys.argv[1:] in (["--qmm"], ["--qmm-times"]):
        sys.exit(qmm_main(check=sys.argv[1] == "--qmm"))
    if sys.argv[1:] == ["--flash-f32-times"]:
        sys.exit(flash_f32_times_main())
    if sys.argv[1:] == ["--surfaces"]:
        sys.exit(surfaces_main())
    if sys.argv[1:] == ["--decode-times"]:
        sys.exit(decode_times_main())
    sys.exit(main())
