#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py                # all phases
    python3 chip_smoke.py --kernels-only # build + phase 1 only
    python3 chip_smoke.py --profile      # + device-time breakdowns

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``,
``sm_90a``), prints each wgmma/TMA kernel's ``-Xptxas -v`` line and its
``HGMMA`` / ``UTMALDG`` counts (``cuobjdump -sass``), each split-K
paged kernel's line and its bulk and ``LDGSTS`` copy counts, and the fp8
Adam kernel's line and its TMA and bulk copy counts, checks that the
sampler's, the softmax rows kernels' and RoPE's variants use no local
memory and call out of line at most once and never, as the GroupNorm
cluster kernels must, which also need TMA loads (``_call_report``),
logs the registers and occupancy of the RoPE kernel and the softmax
backward (``_occupancy_report``), and then runs
twenty-six phases, in the order 1, 2, 3, 6, 7,
4, 5, 17, 10, 12, 18, 11, 8, 9, 15, 16, 13, 14, 19, 20, 21, 22, 23, 24, 25,
26
(Llama-2-7B is built once for 3, 6 and 7 and dropped before 4); any
failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (Llama-2-7B width) and the training path's
   (BERT-Large: LayerNorm forward with statistics and backward, the
   backward rerunning bitwise in bf16, flash attention forward, dq and
   dk/dv, each against its own bound and with SDPA's forward or backward
   alone as yardstick, all three rerunning bitwise in bf16; a causal GQA
   window case at d=128; ViT-Huge's (32, 257, 16 heads, d=80) in bf16,
   fp16 and fp32, dq and dk/dv on the wgmma route in half types and
   rerunning bitwise, each flash row's route logged; the flash edge
   checks, among them the Hopper kernels' 128-row tile edges, head_dim
   256, the d=80 backward's edges and 70400 batch x heads;
   RoPE bit for bit: one operand at the decode and prefill shapes, q and
   k read from the packed projection in one launch at the chunked-prefill
   and decode steps' shapes, the backward alone, and its edges (both qkv
   layouts, GQA, partial spans, head dims 8-256, fp32/bf16/fp16, an
   unaligned view); the fused sampler at 4 x 32000, 8 x 128256, 16 x
   32000, 4 x 50257 and 40 x 128256 rows, tokens equal to the plain
   version's but for nucleus ties and bitwise on a rerun, and at its
   edges: vocabularies 1 to 10^6, top_k 1 to above the vocabulary, top_p
   1e-4 and 0.9999, ties and flat rows, 200 rows), and the paged kernels
   at the paged path's (decode,
   chunked prefill, speculative verify; int8/fp8 pools, GQA, garbage in
   dead pages; the fused decode step's written pages, codes and scales
   bitwise; the Hopper chunk kernel's edges — 16 lanes, d 64, fp16,
   lengths 0 / 15 / 16, pages of 8 — and pages of 128 on the tile
   kernel; the split-K kernels at the engine's 256-page tables, on one
   4000-token row, at 2 and 8 verify lanes and lengths 0 / 1 / 15 / 16 /
   17; head dims 96 and 256 through the split, tile and fused kernels,
   80 with guarded channels, 72 on int8 pages; the fused decode step
   with 16 and 12 query heads per kv head; decode, decode/int8,
   decode/d80, verify, the fused decode (output, pages, scales), the
   chunk kernel and the LayerNorm forward rerunning bitwise), the
   kernels' envelope (head_dim 36 through flash and both paged ops, 264
   through flash: a logged route to the plain version, no launch, the
   plain version's output bitwise),
   and the four BatchNorm passes at the ResNet path's (the
   stem's and stage 0's last BN, bf16 and fp32; the maps bitwise, the
   reductions within 1e-5 of the summed magnitudes, bf16 reruns
   bitwise), the fp8 Adam step at BERT-Large's per-leaf layout and on
   small and transposed leaves (params, codes and scales bitwise over
   three steps, a non-finite step writes nothing, ties and subnormals
   of the conversion), and the scale-mask softmax forward and backward
   at BERT-Large's padded and GPT's causal scores (fp32 within 2e-6,
   half types within one ulp, both bitwise on a rerun; sq < sk, ragged
   sk, a fully masked row, a
   2000-wide row; at sk % 128 != 0 the backward's zeros at every masked
   position), and the GroupNorm(+SiLU) forward and backward at the
   (8, 64x64, 512) cell in bf16 and fp32 on the cluster route and a VAE
   decoder's (1, 512x512, 128) bf16 on the three-pass route (C = 320,
   odd spatial, no affine, 2-D, a mean offset of 100; fp32 within 2e-5,
   bf16 reruns bitwise on both routes), with times: the kernel, its
   plain version, the one
   PyTorch call computing the same function where there is one (a
   yardstick only), and the bound — the larger of bytes over 3.35 TB/s
   and operations over the card's peak rate for their type.
2. Engine identity at full width and depth 2 (fp32, TF32 off): greedy
   ``InferenceServer`` results equal ``generate()``; sampled requests
   equal themselves on a rerun with the same seeds; the paged server's
   greedy results equal ``generate()`` across page and chunk boundaries,
   with speculation, a shared prefix and a pool small enough to preempt,
   and its sampled requests equal the dense server's.
3. Serving: Llama-2-7B at full depth in bf16 with random weights from a
   seeded generator, served by ``InferenceServer`` (4 slots, buckets
   32/128/512) for 8 requests; every kernel of the path must launch;
   a steady decode step launches RoPE once a layer on q and k read from
   the packed projection (no copy of either).
6. Paged serving: the same model from a paged pool of 16384 tokens (8
   slots, pages of 16, chunks of 128) for 16 requests of 20-1000 prompt
   tokens, then steady decode at 4 and 8 slots (and, under ``--profile``,
   B-10's device ms per steady decode step and chunked-prefill steps of 8
   slots, B-9's device ms per step); both paged kernels must launch and
   every page come back; a chunked-prefill step of 8 slots launches
   RoPE once a layer on q and k read from the projection.
7. The same on int8 pages with prefix sharing and 3 lookup drafts: 8
   requests, 4 behind one 256-token system prompt, run twice; greedy
   results must repeat; then steady decode at 4 slots (under
   ``--profile``, B-9's and B-10's device ms per verify step).
4. Training: BERT-Large amp O2 (bf16, fp32 masters, FusedAdam with fp32
   moments, remat), b=16, s=512, 80 masked positions — ``bench.py``'s
   step — 3 warm-up and 10 timed steps on one batch, with the
   fwd/bwd/opt split, the host's enqueue time per step, peak memory,
   launches per step of each training
   kernel (which must equal the path's counts), and the O0 fp32 baseline
   with a plain per-tensor Adam (``vs_baseline = t_O0 / t_O2``).
5. Training identity: BERT-Large width, 2 layers, fp32, TF32 off, b=2,
   s=512, padded keys and attention dropout: loss, logits and every
   parameter's gradient on the card equal the plain path on the CPU.
8. ResNet training: ResNet-50 amp O2 (bf16, fp32 masters, FusedSGD lr
   0.1, momentum 0.9, weight decay 1e-4), fused BN, space-to-depth stem,
   b=128 at 224×224 (``bench_configs.py``'s main ResNet row), random
   seeded weights and one seeded batch: 3 warm-up and 10 timed steps with
   samples/s, the fwd/bwd/opt split, host enqueue ms, peak memory, and
   53 launches per step of each BN kernel; the loss must stay finite and
   fall below its value at initialisation.
9. ResNet identity: a tiny ResNet (stages (1, 1), width 64, 10 classes,
   fp32, TF32 off, b=4, 64×64, both stems): logits, running statistics
   and every gradient on the card equal the plain path on the CPU.
10. Training with fp8 Adam moments: phase 4's step with
   ``fused_adam(1e-4, moment_format="fp8_block_scaled")`` (``bench.py``'s
   ``BENCH_MOMENT_DTYPE=fp8``; no O0 baseline), with phase 4's figures,
   peak memory beside phase 4's and one ``fp8_adam`` launch per step;
   then a step with an inf planted in a gradient changes no master,
   code, scale or count.
11. ``FusedScaleMaskSoftmax`` as Megatron calls it (scores ``q @ k^T``,
   probs, ``probs @ v``, forward and backward) at BERT-Large's padded
   and GPT's causal scores: q, k, v gradients equal the plain chain's
   within 1e-2 of their largest entry, one launch of each softmax
   kernel per call.
12. fp8 optimizer identity: a 2-layer BERT-Large-width model, 3 amp O2
   steps with fp8 moments on the card and on the CPU fed the same
   gradients: codes and scales within one e4m3 quantum (the count that
   differ reported), masters within 1e-6.
13. GroupNorm and the attention block at full width: the
   ``GroupNorm(32, 512, act="silu")`` module at (8, 64, 64, 512) bf16
   forward and backward (ms per call, device ms and CUDA kernels per
   call, one launch of each cluster-route GroupNorm kernel per call), and
   ``GroupNorm(32, 128, act="silu")`` at (1, 512, 512, 128) bf16 on the
   three-pass route; ``SelfMultiheadAttn`` at BERT-Large width (b=16,
   s=512, bias, norm-add, key padding; then causal), and
   ``EncdecMultiheadAttn`` and ``FusedDenseGeluDense(4096, 1024)`` on
   the same activations: gradients against the plain path on the card
   within a stated share of their largest entry, kernel launches counted.
14. Spatial block identity: GroupNorm+SiLU, self-attention with
   norm-add over the 16x16 tokens, dense-GELU-dense at C = 512, b = 2,
   fp32, TF32 off: output and every gradient on the card equal the CPU's
   plain path within 1e-4 of their largest entry.
15. ResNet training under amp O1 (``bench_configs.py``'s ``resnet50_o1``):
   phase 8's model, batch, FusedSGD and figures with fp32 parameters and
   a bf16 compute copy (the BN parameters fp32), no masters; 53 launches
   per step of each BN kernel, a falling loss, and the stored parameters
   the module's own fp32 views of one flat buffer.
16. ResNet O1 identity: phase 9's tiny ResNet (both stems), one O1 +
   FusedSGD step on the card and on the CPU: loss and logits within 1e-4
   of their largest entry, running statistics within 1e-5; gradients and
   parameter changes within 1e-4 unless a ReLU or max-pool decision
   differs between the devices (counted); on each device O1's gradients
   equal, bit for bit, the O0 step's on weights rounded to bf16
   beforehand.
17. BERT-Large amp O1 (``bench_configs.py``'s ``bert_o1``): ``dtype=None``
   and remat under ``amp.o1.o1_intercept(bfloat16)``, FusedAdam(1e-4),
   b=16, s=512: 3 warm-up and 10 timed steps with samples/s, host ms a
   step, peak memory and phase 4's launch counts; the profiler's record
   shows every product of the half classes in bf16 (the tied decoder's
   one product in fp32, the embedding's class), every LayerNorm kernel in
   its fp32 variant and every flash kernel in bf16.
18. The optimizers of ``optim`` (FusedLAMB, FusedMixedPrecisionLamb,
   FusedNovoGrad, FusedAdagrad, LARC around FusedSGD) and
   ``clip_grad_norm`` over BERT-Large's 3.36e8 parameters, ms a step;
   one step at BERT-base's shapes on the card equal to the CPU's within
   rtol 1e-6 / atol 1e-7.
19. GroupNorm at a batch of 65537 (three passes, (65537, 4x4, 320) bf16,
   forward and backward against the plain versions) and on a permuted
   NCHW view (output and the NCHW gradient equal to the contiguous
   call's bit for bit).
20. Remat policies: phase 4's BERT-Large O2 step, 3 steps under each of
   ``nothing_saveable``, ``save_only:attn_out,attn_lse``,
   ``dots_with_no_batch_dims_saveable`` and ``remat_skip_every=2``:
   losses and every gradient bit for bit equal to ``nothing_saveable``'s,
   flash-forward launches a step 48 / 24 / 48 / 36, and the peak memory
   of each (the prediction for ``save_only`` printed first).
21. Mistral-7B ``generate`` at its published widths and 32 layers,
   bf16, seeded random weights: b = 2 prompts of 6144 tokens prefilled in
   one call (4096 rows through the ring cache's blocked path, 2048
   through the banded flash forward), 64 greedy tokens, TTFT, decode
   tokens/s and peak memory; each step's logits against a full-sequence
   windowed forward over the same ids, ``prefill_chunk=2048`` against
   the single call, a sampled run, the ring's 1.07 GB against a dense
   cache's 2.15 GB, and the banded kernel at the ring's shape.
22. Mixtral-8x7B at its published widths with 8 of 32 layers (all 32
   need ~93 GB of bf16 weights): b = 2 prompts of 1024 tokens, 32 greedy
   tokens and a sampled run with the drop-free capacity, logits checked
   as in 21, ``moe_aux_loss`` finite; a tiny MoE model's amp O2 step on
   the card against the CPU.
23. ViT-Huge amp O2 + FusedLAMB (``bench_configs.py``'s ViT row, b = 32
   at 224, remat): 3 warm-up and 10 timed steps with samples/s, host ms,
   the fwd/bwd/opt split, peak memory and the LayerNorm and flash
   launches a step, and the step's attention ms (each flash kernel's ms
   at the step's shape times its launches); every timed loss below the
   loss at initialisation; ViT-tiny's O2 + FusedLAMB step on the card
   against the CPU.
24. GPT-2 1.3B (24 layers, hidden 2048, 16 heads of 128, vocab 50304,
   learned positions) in bf16 with remat, amp O2 + FusedAdam (bf16
   moments), b = 8 x s = 1024, on the parallel path at a world of one
   over NCCL (``init_distributed`` with no environment: a file store):
   a mesh with a tensor axis of 1, sequence parallelism and ZeRO-2 over
   the data axis, every collective called.  One step bitwise equal to
   the same seeded step without a mesh and with the plain FusedAdam
   state (loss, gradients, fp32 masters, parameters); 3 warm-up and 10
   timed steps with samples/s, tokens/s, host ms, the split, peak
   memory and the LayerNorm / flash launches a step; the initial loss
   within 0.8-1.6 ln V, the loss falls.  The flash kernels' dropout
   lanes for a tensor-parallel rank's heads: bitwise equal to the whole
   call's heads.
25. ResNet-50 amp O1 + FusedSGD (phase 15's model) at b = 128 with
   ``convert_syncbn_model`` over the data axis and
   ``DistributedDataParallel.mean_grads`` each step, at a world of one
   over NCCL: one step bitwise equal to the local-BN step without DDP
   (loss, gradients, parameters, running statistics); 3 warm-up and 10
   timed steps, 53 launches a step of each BN kernel, the loss below its
   initial value; one step over the int8 all-reduce, finite.
26. Phase 24's GPT-2 1.3B (its weights and batch) through the pipeline
   at a world of one over NCCL (pipe, data and tensor axes of 1): the
   stages from ``build_model`` with per-layer remat, the embedding,
   positions, final norm and an untied copy of the head closed over the
   pipelined region, M = 4 microbatches of 2, amp O2 + FusedAdam (bf16
   moments) with stage-local ZeRO-2, the step ``wrap_pipeline_step``.
   One step bitwise equal to ``forward_backward_no_pipelining`` over the
   same microbatches (loss, gradients, fp32 masters, parameters), the
   loss within 2e-3 of the whole model's; 3 warm-up and 10 timed steps
   with phase 24's measures beside its own, the LayerNorm / flash
   launches a step four times phase 24's; the initial loss within
   0.8-1.6 ln V, the loss falls; the schedule's peak memory (before
   ``apply_gradients``) at M = 8 no more than at M = 4 plus the O(M)
   buffers and 64 MiB.  Phases 24 and 26 each break one more step's
   memory down by owner and by the allocating line of the port.
27. Context parallelism at Mistral-7B's attention widths (32 / 8 heads,
   d 128), bf16, b 1, causal, S = 32768, at a world of one over NCCL:
   ring attention forward and dq / dk / dv bitwise equal to
   ``fused_attention`` (one tick), remat bitwise equal to no remat; the
   virtual ring at cp 4 within 2^-5 of ``fused_attention`` at each
   element of o, dq, dk and dv (of its magnitude plus the tensor's RMS),
   with 10 launches of each flash kernel (the 6 dead chunks of 16
   skipped), two faults planted in its merge outside 2^-4 on every
   tensor, and within 2^-4 of the plain ring at S = 4096;
   Ulysses bitwise equal to ``fused_attention``, with and without a
   window of 4096; the ms of each call and the peak bytes.
28. One MoE layer at Mixtral-8x7B's widths (4096 / 14336, 8 experts, top
   2, SwiGLU), bf16, b 2 x s 1024, on a world-of-one NCCL mesh with the
   experts over the tensor axis and over the data axis (the token
   all-to-all): output, aux and every gradient bitwise equal to the
   layer without a mesh; the ms of each.
29. Llama-2-7B bf16 through ``PagedEngine(mesh=<Mesh>)`` and
   ``InferenceServer(kv_cache="paged", mesh=...)`` at a world of one
   over NCCL beside the single-chip engine: steady decode at 4 and 8
   slots of phase 6's ~500-token contexts, 8 greedy server requests and
   4 slots on int8 pages, tokens identical; ``health()`` reports 1 chip
   a replica and the mesh shape; decode tokens/s, TTFT p50/p99, host and
   device ms a step, idle share and peak bytes of both.

A failed phase is also reported on standard error, last: its name, the
lines it logged that name a failed check, and its last lines.

The last lines of standard output are the card's name and power limit,
the ``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
Details also go to ``<--out>/chip_smoke.json`` (default
``build/chip_smoke``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
# H100 SXM INT32: 64 lanes per SM x 132 SMs x 1.98 GHz, one operation a
# lane a cycle: the int32 work counted here (threefry's adds, xors and
# rotates) has no multiply-add to count twice
INT32_OPS_PER_S = 16.7e12
VOCAB = 32000

_FA = "apex_tpu_torch/csrc/flash_attention.cu"
_PA = "apex_tpu_torch/csrc/paged_attention.cu"
_BN = "apex_tpu_torch/csrc/batch_norm.cu"
_SM = "apex_tpu_torch/csrc/softmax.cu"
_GN = "apex_tpu_torch/csrc/group_norm.cu"
KERNELS = {
    "layer_norm": dict(source="apex_tpu_torch/csrc/layer_norm.cu",
                       replaces="apex_tpu/ops/layer_norm.py:74"),
    "layer_norm_bwd": dict(source="apex_tpu_torch/csrc/layer_norm.cu",
                           replaces="apex_tpu/ops/layer_norm.py:93"),
    "rope": dict(source="apex_tpu_torch/csrc/rope.cu",
                 replaces="apex_tpu/ops/rope.py:83"),
    "fused_sampling": dict(source="apex_tpu_torch/csrc/fused_sampling.cu",
                           replaces="apex_tpu/ops/fused_sampling.py:246"),
    "flash_attention_fwd": dict(source=_FA,
                                replaces="apex_tpu/ops/attention.py:367"),
    "flash_attention_bwd_dq": dict(source=_FA,
                                   replaces="apex_tpu/ops/attention.py:577"),
    "flash_attention_bwd_dkv": dict(
        source=_FA, replaces="apex_tpu/ops/attention.py:649"),
    "paged_attention": dict(source=_PA,
                            replaces="apex_tpu/ops/paged_attention.py:376"),
    "paged_decode_fused": dict(
        source=_PA, replaces="apex_tpu/ops/paged_attention.py:639"),
    "bn_reduce": dict(source=_BN, replaces="apex_tpu/ops/batch_norm.py:152"),
    "bn_apply": dict(source=_BN, replaces="apex_tpu/ops/batch_norm.py:166"),
    "bn_bwd_reduce": dict(source=_BN,
                          replaces="apex_tpu/ops/batch_norm.py:188"),
    "bn_bwd_dx": dict(source=_BN, replaces="apex_tpu/ops/batch_norm.py:211"),
    "fp8_adam": dict(source="apex_tpu_torch/csrc/fp8_adam.cu",
                     replaces="apex_tpu/optim/fused_adam.py:112"),
    "softmax_fwd": dict(source=_SM, replaces="apex_tpu/ops/softmax.py:66"),
    "softmax_bwd": dict(source=_SM, replaces="apex_tpu/ops/softmax.py:85"),
    "group_norm_fwd": dict(source=_GN,
                           replaces="apex_tpu/ops/group_norm.py:95"),
    "group_norm_bwd": dict(source=_GN,
                           replaces="apex_tpu/ops/group_norm.py:142"),
    "group_norm_fwd_3pass": dict(source=_GN,
                                 replaces="apex_tpu/ops/group_norm.py:95"),
    "group_norm_bwd_3pass": dict(source=_GN,
                                 replaces="apex_tpu/ops/group_norm.py:142"),
}
SERVING_KERNELS = ("layer_norm", "rope", "fused_sampling")
PAGED_KERNELS = ("paged_attention", "paged_decode_fused")
# BERT-Large O2, remat: launches per training step of each kernel entry —
# LayerNorm forward 50 (2 per layer, embedding, MLM head) plus 48
# recomputed, its backward 50; flash forward 24 plus 24 recomputed, dq
# and dk/dv 24 each
TRAIN_LAUNCHES = {"layer_norm": 98, "layer_norm_bwd": 50,
                  "flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                  "flash_attention_bwd_dkv": 24}
# device ms per BERT step of each hand kernel of the path and of cuBLAS's
# GEMMs (phases 4 and 10 under --profile); the rest under "other"
BERT_GROUPS = {"flash_fwd": r"fa_fwd_", "flash_dq": r"fa_bwd_dq_",
               "flash_dkv": r"fa_bwd_dkv_", "layer_norm": r"ln_fwd_",
               "layer_norm_bwd": r"ln_bwd_dx", "fp8_adam": r"fp8_adam_kernel",
               "gemms": r"nvjet|gemm|cutlass"}
# device ms per chunked-prefill step of phase 6 (under --profile): B-9,
# the other hand kernels of the step, cuBLAS's GEMMs; the rest "other"
PREFILL_GROUPS = {"paged_attention": r"paged_attn_", "layer_norm": r"ln_fwd_",
                  "rope": r"rope", "gemms": r"nvjet|gemm|cutlass"}
# device ms per steady decode or verify step of phases 6 and 7 (under
# --profile): B-10, B-9 (a verify step), the other hand kernels of the
# step, cuBLAS's GEMMs; the rest "other"
DECODE_GROUPS = {"paged_decode_fused": r"paged_decode_",
                 "paged_attention": r"paged_attn_", "layer_norm": r"ln_fwd_",
                 "rope": r"rope", "fused_sampling": r"sample_cluster_kernel",
                 "gemms": r"nvjet|gemm|cutlass"}
# ResNet-50: 53 BNs (the stem, 3 per block x 16, 4 bn_down), each one
# launch of each pass per step (no remat)
BN_KERNELS = ("bn_reduce", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
RESNET_BN_LAUNCHES = 53


#: the lines the running phase has logged, repeated on standard error if
#: it fails (a caller that keeps only the end of that stream sees why)
PHASE_LINES: list = []


def log(*a):
    print(*a, flush=True)
    PHASE_LINES.append(" ".join(str(x) for x in a))


def gate(name, passed):
    """``passed`` as a bool; a failed check logs its ``name``."""
    if not passed:
        log(f"  FAIL: {name}")
    return bool(passed)


def report_failure(name, lines, limit=16000):
    """Write phase ``name``'s failure to standard error: its lines that
    name a failed check, then its last lines, within ``limit`` chars."""
    marks = ("FAIL", "NOT ", "False", "expected", "Traceback", "Error")
    picked = [ln for ln in lines if any(m in ln for m in marks)]
    picked += ["  ... last lines of the phase:"] + lines[-8:]
    text = "\n".join(ln if len(ln) <= 1500 else ln[:1500] + " ..."
                     for ln in picked)
    print(f"chip_smoke: phase {name} FAILED\n{text[-limit:]}",
          file=sys.stderr, flush=True)


def timed(torch, fn, iters=50, warmup=5):
    """``(device_ms, call_ms)`` of one call of ``fn``: the device time of
    the kernels it launches (torch.profiler, summed over ``iters`` calls)
    and the mean time per call of ``iters`` back-to-back calls between
    CUDA events, which includes the host's launch cost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # the profiler now and then reports no kernel at all (seen once on a
    # LayerNorm row): profile again rather than record 0 ms
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(_device_us(e) for e in prof.key_averages()
                     if _is_kernel(e))
        if dev_us > 0:
            break
    return dev_us / iters / 1e3, call_ms


def queued_event_ms(torch, fn, iters=20, warmup=5, sleep_cycles=50_000_000):
    """Device ms per call of ``fn`` between CUDA events, with the host's
    enqueue hidden: the stream first sleeps on the device (~25 ms) while
    the host queues every call, so the events time the calls back to back
    on the device even where one call takes the host longer to enqueue
    than the device to run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _is_kernel(event):
    # a CPU op's self device time repeats the time of its kernels
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def _device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def bound(nbytes, ops, int_ops=0, ops_per_s=FP32_OPS_PER_S):
    """Least time (ms) for the work, and what bounds it: ``nbytes`` over
    the memory rate against ``ops`` operations at ``ops_per_s`` (fp32
    outside the tensor cores unless given) and ``int_ops`` int32
    operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_per_s, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp_ok(torch, got, ref, floor=0.0):
    """|got - ref| within one bf16 ulp of ref (plus ``floor``),
    elementwise."""
    r = ref.float().abs()
    ulp = torch.where(r > 0, torch.exp2(torch.floor(torch.log2(
        r.clamp(min=1e-30))) - 7), torch.full_like(r, 1e-30))
    return bool(((got.float() - ref.float()).abs() <= ulp + floor).all())


# ------------------------------------------------------------------ #
# phase 1: kernels against their plain versions
# ------------------------------------------------------------------ #
def phase_kernels(torch, rows_out):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import fused_sampling as fs
    from apex_tpu_torch.ops.layer_norm import (
        fused_layer_norm, fused_rms_norm, layer_norm_reference,
        rms_norm_reference)
    from apex_tpu_torch.ops.rope import (
        fused_rope, rope_cos_sin, rope_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True

    def record(kernel, shape, dtype, err, passed, kern, plain, nbytes,
               ops, lib, tol, int_ops=0, ops_per_s=FP32_OPS_PER_S,
               iters=None, lib_events=False, extra=None):
        """``kern`` / ``plain`` / ``lib``: functions to time (lib may be
        None); times are device ms per call, call ms beside them.
        ``lib_events``: take the library's time from CUDA events with
        the host's enqueue hidden (:func:`queued_event_ms`) — the profiler
        does not see every kernel of ``scaled_dot_product_attention`` (it
        reported 0 device ms for its flash backend), and its backward
        takes the host longer to enqueue than the device to run.
        ``extra``: more fields for the row."""
        bms, by = bound(nbytes, ops, int_ops, ops_per_s)
        if iters is None:
            iters = 20 if kernel == "fused_sampling" else 50
        t_k, t_p = timed(torch, kern, iters), timed(torch, plain, iters)
        t_l = None if lib is None else timed(torch, lib, iters)
        row = dict(kernel=kernel, shape=shape, dtype=str(dtype), err=err,
                   passed=passed, ms=t_k[0], call_ms=t_k[1],
                   plain_ms=t_p[0], plain_call_ms=t_p[1],
                   library_ms=None if t_l is None else (
                       queued_event_ms(torch, lib, iters) if lib_events
                       else t_l[0]),
                   library_device_ms=None if t_l is None else t_l[0],
                   library_call_ms=None if t_l is None else t_l[1],
                   bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                   int_ops=int_ops, tolerance=tol, **(extra or {}))
        rows_out.append(row)
        lib_txt = "-" if t_l is None else (
            f"{t_l[0]:.5f}/{t_l[1]:.4f}" + (
                f" (queued events {row['library_ms']:.5f})" if lib_events
                else ""))
        log(f"  {kernel:22s} {str(shape):22s} {str(dtype)[6:]:9s} "
            f"err={err:.3g} {'ok' if passed else 'FAIL'}  device/call ms: "
            f"kernel={t_k[0]:.5f}/{t_k[1]:.4f} "
            f"plain={t_p[0]:.5f}/{t_p[1]:.4f} library={lib_txt} "
            f"bound={bms:.6f} ({by})")
        return passed

    log("phase 1: kernels vs plain versions")
    # RMSNorm at the decode (4 rows) and prefill (512 rows) shapes, and
    # LayerNorm with bias (GPT's norm) at h=2048
    cases = [("rms", r, 4096, dt) for r in (4, 512)
             for dt in (torch.bfloat16, torch.float32)]
    cases.append(("ln", 512, 2048, torch.float32))
    cases.append(("ln", 4, 2048, torch.bfloat16))
    for kind, rows, h, dt in cases:
        x = torch.randn(rows, h, generator=g, device=dev).to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dt)
        b = (0.1 * torch.randn(h, generator=g, device=dev)).to(dt)
        if kind == "rms":
            def kern(): return fused_rms_norm(x, w, eps=1e-5)
            def plain(): return rms_norm_reference(x, w, eps=1e-5)
            lib = (lambda: F.rms_norm(x, (h,), w, eps=1e-5)) \
                if hasattr(F, "rms_norm") else None
            nparam = 1
        else:
            def kern(): return fused_layer_norm(x, w, b, eps=1e-5)
            def plain(): return layer_norm_reference(x, w, b, eps=1e-5)
            def lib(): return F.layer_norm(x, (h,), w, b, eps=1e-5)
            nparam = 2
        y, r = kern(), plain()
        torch.cuda.synchronize()
        err = float((y.float() - r.float()).abs().max())
        if dt == torch.float32:
            passed = bool(torch.allclose(y, r, rtol=1e-5, atol=1e-5))
            tol = "rtol 1e-5, atol 1e-5"
        else:
            passed = bf16_ulp_ok(torch, y, r)
            tol = "1 bf16 ulp"
        isz = x.element_size()
        nbytes = 2 * rows * h * isz + nparam * h * isz
        ops = (4 if kind == "rms" else 7) * rows * h
        ok &= record("layer_norm" if kind == "ln" else "rms_norm",
                     (rows, h), dt, err, passed, kern, plain, nbytes, ops,
                     lib, tol)

    # RoPE: decode (4, 1, 32, 128) and prefill (1, 512, 32, 128), shared
    # and per-row tables, one operand through fused_rope; equal to the
    # plain version bit for bit
    cos_t, sin_t = rope_cos_sin(4096, 128, device=dev)
    for shape in ((4, 1, 32, 128), (1, 512, 32, 128)):
        b_, s_, h_, d_ = shape
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            for per_row in (False, True):
                if per_row:
                    pos = torch.randint(0, 4096 - s_, (b_, 1), generator=g,
                                        device=dev) + torch.arange(
                                            s_, device=dev)
                    c, s = cos_t[pos], sin_t[pos]
                else:
                    c, s = cos_t[100:100 + s_], sin_t[100:100 + s_]
                def kern(): return fused_rope(x, c, s)
                def plain(): return rope_reference(x, c, s)
                y, r = kern(), plain()
                torch.cuda.synchronize()
                err = float((y.float() - r.float()).abs().max())
                nbytes = 2 * x.numel() * x.element_size() + 2 * c.numel() * 4
                ops = 6 * x.numel() // 2
                ok &= record("rope" + ("/per_row" if per_row else ""),
                             shape, dt, err, torch.equal(y, r), kern, plain,
                             nbytes, ops, None, "bitwise")
    ok &= _rope_qk_rows(torch, g, record, cos_t, sin_t)

    # fused sampling over a grid of row kinds: fp32 at the served and
    # the 128k-vocab shapes, and bf16 at the served shape, which is what
    # the Llama-2-7B bf16 head hands the engine
    grid_4 = [
        # (temperature, top_k, top_p)
        [(0.0, 0, 0.0), (0.8, 0, 0.0), (1.0, 40, 0.0), (0.9, 0, 0.9)],
        [(0.7, 50, 0.8), (1.2, 5, 0.5), (1.0, 0, 0.0), (0.0, 0, 0.0)],
    ]
    grid_8 = [(0.0, 0, 0.0), (0.0, 0, 0.0), (1.0, 0, 0.0), (0.6, 0, 0.0),
              (1.0, 100, 0.0), (0.8, 0, 0.95), (0.7, 40, 0.9),
              (1.1, 1000, 0.5)]
    # Llama-2's served shape; Llama-3's 128256 entries at 8 slots; phase
    # 7's verify (4 slots x (1 + 3 drafts)); GPT-2's 50257; 40 rows of
    # 128256, more clusters than the card runs at once
    grids = [
        ((4, 32000), torch.float32, grid_4),
        ((4, 32000), torch.bfloat16, grid_4),
        ((8, 128256), torch.float32, [grid_8]),
        ((8, 128256), torch.bfloat16, [grid_8]),
        ((16, 32000), torch.bfloat16, [
            [(0.8, 40, 0.9), (1.0, 0, 0.0), (0.0, 0, 0.0), (0.7, 0, 0.95)]
            * 4]),
        ((4, 50257), torch.float16, [grid_4[0]]),
        ((40, 128256), torch.bfloat16, [grid_8 * 5]),
    ]
    log(f"  sampling: clusters the card runs at once, by size "
        f"{fs._capacity(dev, torch.float32)}")
    for (rows, vocab), dt, configs in grids:
        for gi, cfgs in enumerate(configs):
            logits = (2.0 * torch.randn(rows, vocab, generator=g,
                                        device=dev)).to(dt)
            t = torch.tensor([c[0] for c in cfgs], device=dev)
            k = torch.tensor([c[1] for c in cfgs], dtype=torch.int32,
                             device=dev)
            p = torch.tensor([c[2] for c in cfgs], device=dev)
            seeds = torch.randint(0, 2 ** 31, (rows,), generator=g,
                                  device=dev)
            keys = fs.split(torch.stack([fs.prng_key(int(s), dev)
                                         for s in seeds.tolist()]))[:, 0]
            def kern(): return fs.fused_sample(logits, keys, t, k, p)
            def plain(): return fs.fused_sample_reference(
                logits, keys, t, k, p, vocab)
            y, r, y2 = kern(), plain(), kern()
            torch.cuda.synchronize()
            mism = (y != r).nonzero().flatten().tolist()
            ties = [i for i in mism if _nucleus_tie(
                torch, logits[i], cfgs[i], int(y[i]), int(r[i]))]
            rerun = torch.equal(y, y2)
            passed = len(mism) == len(ties) and rerun
            err = float((y.long() - r.long()).abs().max())
            nbytes = fs.sampling_cost_bytes(rows, vocab, logits.dtype)
            fp_ops = sum(_sampling_ops(vocab, c)[0] for c in cfgs)
            int_ops = sum(_sampling_ops(vocab, c)[1] for c in cfgs)
            plan = fs.sample_plan(rows, vocab, logits.element_size(),
                                  fs._capacity(dev, logits.dtype))
            log(f"  sampling {rows}x{vocab} {str(dt)[6:]} grid {gi} "
                f"(cluster, slice, resident) {plan}: "
                f"{'kernel == plain' if not mism else 'kernel ' + str(y.tolist()) + ' plain ' + str(r.tolist())}"
                f", nucleus ties {ties}, rerun bitwise {rerun}")
            ok &= record("fused_sampling", (rows, vocab), logits.dtype,
                         err, passed, kern, plain, nbytes, fp_ops, None,
                         "tokens equal (nucleus-boundary ties excepted)",
                         int_ops=int_ops)
    ok &= _sampling_edge_checks(torch, g)
    ok &= _rope_edge_checks(torch, g)
    ok &= _layer_norm_training_rows(torch, g, record)
    ok &= _flash_rows(torch, g, record)
    ok &= _flash_edge_checks(torch, g)
    ok &= _paged_rows(torch, g, record, rows_out)
    ok &= _envelope_checks(torch, g)
    ok &= _batch_norm_rows(torch, g, record)
    ok &= _fp8_adam_rows(torch, g, record)
    ok &= _softmax_rows(torch, g, record)
    ok &= _group_norm_rows(torch, g, record)
    return ok


def _paged_pool(torch, g, dev, *, b, hk, d, bs, lengths, s, dtype,
                spare=64, width=None):
    """A pool holding each row's ``lengths[i] + s`` tokens on shuffled
    pages, with ``spare`` dead pages and the null page full of large
    garbage (1e4 x the live scale) that the mask must keep out; tables of
    ``width`` pages (default: as wide as the longest row needs; the rest
    of a row's entries point at the null page, as the engine's do)."""
    need = [-(-(n + s) // bs) for n in lengths]
    nb = 1 + sum(need) + spare
    mb = max(need) if width is None else width
    kp = torch.randn(hk, nb, bs, d, generator=g, device=dev)
    vp = torch.randn(hk, nb, bs, d, generator=g, device=dev)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    tables = torch.zeros(b, mb, dtype=torch.int32, device=dev)
    live, at = [], 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n].int()
        live.append(perm[at:at + n])
        at += n
    live = torch.cat(live)
    dead = torch.ones(nb, dtype=torch.bool, device=dev)
    dead[live] = False
    kp[:, dead] *= 1e4
    vp[:, dead] *= 1e4
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return kp.to(dtype), vp.to(dtype), tables, lens, live


def _paged_rows(torch, g, record, rows_out):
    """The paged kernels against their plain versions: B-9 at the decode
    shape (4 rows of 510/480/333/250 tokens, Llama-2-7B heads), the
    chunked-prefill shape (8 rows, chunk 128, contexts to 1000) and the
    speculative verify (s = 4; MHA at s = 2 and s = 8, the 8-lane edge of
    the split kernel); B-10 at the decode shape with RoPE; int8 and fp8
    pools, GQA (32/8 heads), fp32, dead pages of garbage; the split
    kernels at the engine's 256-page tables, on one 4000-token row and at
    lengths 0 / 1 / 15 / 16 / 17; the Hopper chunk kernel's edges (16
    lanes, d 64, fp16, lengths 0 / 15 / 16, pages of 8) and pages of 128
    on the tile kernel; head dims 96 and 256 (decode, chunk, verify, coded
    pools, fp32), 80 (guarded channels) and 72 on int8 pages (rows not of
    whole 16-byte vectors); the fused decode step with 16 and 12 query
    heads per kv head.  Decode, decode/int8, decode/d80, verify and the
    chunk kernel (bf16 and int8 pages) rerun bitwise, and so does B-10 at
    decode, decode/int8, decode/d80 and decode/gqa16-int8 (output, pages
    and scales).  B-10's written pages, codes
    and scales must equal the plain version's bitwise on live pages.
    There is no PyTorch call for attention over a paged pool (library
    "none"); ``F.scaled_dot_product_attention`` over the same live K/V
    laid out densely is timed beside it as a yardstick
    ("sdpa_dense_ms")."""
    import importlib

    import torch.nn.functional as F

    from apex_tpu_torch.ops.rope import rope_cos_sin

    # the module (the ops namespace exports the function of its name)
    PA = importlib.import_module("apex_tpu_torch.ops.paged_attention")

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    dec = [510, 480, 333, 250]
    chunk = [0, 120, 250, 400, 560, 700, 812, 872]
    cases = [  # tag, b, s, h, hk, lengths, dtype, kv_dtype[, d, bs]
        ("decode", 4, 1, 32, 32, dec, bf16, None),
        ("decode", 4, 1, 32, 32, dec, torch.float32, None),
        ("decode/int8", 4, 1, 32, 32, dec, bf16, "int8"),
        ("decode/fp8", 4, 1, 32, 32, dec, bf16, "fp8"),
        ("decode/gqa", 4, 1, 32, 8, dec, bf16, None),
        ("decode/gqa-int8", 4, 1, 32, 8, dec, bf16, "int8"),
        ("chunk", 8, 128, 32, 32, chunk, bf16, None),
        ("chunk/int8", 8, 128, 32, 32, chunk, bf16, "int8"),
        ("chunk/gqa", 8, 128, 32, 8, chunk, bf16, None),
        ("verify", 4, 4, 32, 32, dec, bf16, None),
        ("verify/fp8", 4, 4, 32, 32, dec, bf16, "fp8"),
        # the edges of the Hopper chunk kernel: 16 lanes (a GQA verify),
        # d 64, fp16 q, an e4m3 pool, lengths 0 / bs - 1 / bs, pages of
        # 8, and pages of 128, which stay on the tile kernel
        ("verify/gqa", 4, 4, 32, 8, dec, bf16, None),
        ("chunk/d64", 8, 128, 32, 32, chunk, bf16, None, 64, 16),
        ("chunk/fp16", 8, 128, 32, 32, chunk, torch.float16, None),
        ("chunk/fp8", 8, 128, 32, 32, chunk, bf16, "fp8"),
        ("chunk/edges", 3, 128, 32, 8, [0, 15, 16], bf16, None),
        ("chunk/bs8", 8, 128, 32, 32, chunk, bf16, None, 128, 8),
        ("chunk/bs128", 8, 128, 32, 32, chunk, bf16, None, 128, 128),
        # the split kernels (up to 8 lanes): the engine's 256-page tables,
        # one long row, the 2- and 8-lane verify, short rows
        ("decode/w256", 4, 1, 32, 32, dec, bf16, None, 128, 16, 256),
        ("decode/int8-w256", 4, 1, 32, 32, dec, bf16, "int8", 128, 16, 256),
        ("decode/long", 1, 1, 32, 32, [4000], bf16, None),
        ("verify/s2", 4, 2, 32, 32, dec, bf16, None),
        ("verify/s8", 4, 8, 32, 32, dec, bf16, None),
        ("decode/edges", 5, 1, 32, 32, [0, 1, 15, 16, 17], bf16, None),
        # head dims other than 64 and 128 (the tile and split kernels at
        # their widths 96 and 256, and d = 80 with guarded channels in the
        # width 96; rows of 1-byte codes that are not whole 16-byte
        # vectors at d = 72), and GQA groups above 8 query heads per kv
        # head in the fused decode step (16 in two lane groups, 12 in
        # groups of 8 and 4)
        ("decode/d96", 4, 1, 32, 32, dec, bf16, None, 96, 16),
        ("chunk/d96", 8, 128, 32, 32, chunk, bf16, None, 96, 16),
        ("verify/d96", 4, 4, 32, 32, dec, bf16, None, 96, 16),
        ("decode/fp8-d96", 4, 1, 32, 32, dec, bf16, "fp8", 96, 16),
        ("decode/d256", 4, 1, 16, 16, dec, bf16, None, 256, 16),
        ("chunk/d256", 8, 128, 16, 16, chunk, bf16, None, 256, 16),
        ("verify/d256", 4, 4, 16, 16, dec, bf16, None, 256, 16),
        ("decode/int8-d256", 4, 1, 16, 16, dec, bf16, "int8", 256, 16),
        ("decode/d256-fp32", 4, 1, 16, 16, dec, torch.float32, None, 256,
         16),
        ("decode/d80", 4, 1, 32, 32, dec, bf16, None, 80, 16),
        ("chunk/d80", 8, 128, 32, 32, chunk, bf16, None, 80, 16),
        ("verify/d80", 4, 4, 32, 32, dec, bf16, None, 80, 16),
        ("decode/int8-d80", 4, 1, 32, 32, dec, bf16, "int8", 80, 16),
        ("decode/int8-d72", 4, 1, 32, 8, dec, bf16, "int8", 72, 16),
        ("decode/gqa16", 4, 1, 64, 4, dec, bf16, None),
        ("decode/gqa16-int8", 4, 1, 64, 4, dec, bf16, "int8"),
        ("decode/gqa12", 4, 1, 48, 4, dec, bf16, None),
    ]
    rerun_tags = ("decode", "decode/int8", "verify", "chunk", "chunk/int8",
                  "decode/d80", "decode/gqa16-int8")
    ok = True
    for tag, b, s, h, hk, lengths, dt, kv, *geom in cases:
        d, bs, width = (list(geom) + [None])[:3] if geom else (128, 16, None)
        cos_t, sin_t = rope_cos_sin(4096, d, device=dev)
        kp, vp, tables, lens, live = _paged_pool(
            torch, g, dev, b=b, hk=hk, d=d, bs=bs, lengths=lengths, s=s,
            dtype=dt, width=width)
        kw = {}
        if kv:
            kp, vp, ks, vs = PA.quantize_kv_pages(kp, vp, kv)
            kw = dict(k_scales=ks, v_scales=vs)
        q = torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
        rel = 1e-5 if dt == torch.float32 else 2 ** -7
        tol = f"o: max |err| <= {rel:g} x max |ref|"
        shape = (b, s, h, hk, d)
        nbytes = PA.paged_cost_bytes(q, kp, lengths)
        pairs = sum(n + i + 1 for n in lengths for i in range(s)) * h
        flops = 4 * pairs * d
        # the products' peak for q's type: bf16 on the tensor cores
        peak = FP32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S

        # the dense yardstick over the same live keys (one SDPA per row
        # would be the fair call; one padded batch is what a caller has)
        kmax = max(lengths) + s
        kd = torch.randn(b, h, kmax, d, generator=g, device=dev).to(
            torch.float32 if dt == torch.float32 else bf16)
        qd = q.transpose(1, 2).to(kd.dtype).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qd, kd, kd,
                                                  enable_gqa=False)
        t_sd = timed(torch, sdpa, 20)
        args = (q, kp, vp, tables, lens)
        got = PA.paged_attention(*args, **kw)
        ref = PA.paged_attention(*args, implementation="torch", **kw)
        torch.cuda.synchronize()
        err, passed = _close_rel(torch, got, ref, rel)
        passed &= bool(torch.isfinite(got).all())
        if tag in rerun_tags and dt == bf16:
            rerun = torch.equal(got, PA.paged_attention(*args, **kw))
            log(f"  paged_attn/{tag} rerun bitwise {rerun}")
            passed &= rerun
            tol += "; rerun bitwise"
        ok &= record(f"paged_attn/{tag}", shape, dt, err, passed,
                     lambda: PA.paged_attention(*args, **kw),
                     lambda: PA.paged_attention(*args, implementation="torch",
                                                **kw),
                     nbytes, flops, None, tol, ops_per_s=peak, iters=20)
        rows_out[-1]["sdpa_dense_ms"] = t_sd[0]
        if s != 1:
            continue
        # B-10 at the same decode shape: the new row at lengths[i]
        pos = lens.long()
        cos_b = cos_t[pos][:, None, None, :]
        sin_b = sin_t[pos][:, None, None, :]
        nk = torch.randn(b, 1, hk, d, generator=g, device=dev).to(dt)
        nv = torch.randn(b, 1, hk, d, generator=g, device=dev).to(dt)
        fkw = dict(max_seq_len=4096, cos_b=cos_b, sin_b=sin_b)
        if kv:
            fkw["chunk_lens"] = torch.ones(b, dtype=torch.int32, device=dev)

        def fused(impl, pools):
            kp_, vp_, *sc = pools
            extra = dict(k_scales=sc[0], v_scales=sc[1]) if sc else {}
            return PA.paged_decode_fused(q, nk, nv, kp_, vp_, tables, lens,
                                         implementation=impl, **fkw, **extra)

        base = [kp, vp] + ([kw["k_scales"], kw["v_scales"]] if kv else [])
        pk = [t.clone() for t in base]
        pt = [t.clone() for t in base]
        out_k = fused("kernel", pk)
        out_t = fused("torch", pt)
        torch.cuda.synchronize()
        err, passed = _close_rel(torch, out_k[0], out_t[0], rel)
        written = all(
            torch.equal(a[:, live].contiguous().view(torch.uint8),
                        r[:, live].contiguous().view(torch.uint8))
            for a, r in zip(out_k[1:], out_t[1:]))
        passed &= written and bool(torch.isfinite(out_k[0]).all())
        log(f"  paged_decode_fused/{tag}: written pages"
            f"{' and scales' if kv else ''} bitwise: {written}")
        if tag in rerun_tags and dt == bf16:
            pr = [t.clone() for t in base]
            again = fused("kernel", pr)
            torch.cuda.synchronize()
            rerun = all(torch.equal(a.view(torch.uint8), r.view(torch.uint8))
                        for a, r in zip((out_k[0],) + tuple(pk),
                                        (again[0],) + tuple(pr)))
            log(f"  paged_decode_fused/{tag} rerun bitwise (output, pages"
                f"{', scales' if kv else ''}) {rerun}")
            passed &= rerun
            del pr, again
        ok &= record(f"paged_decode_fused/{tag}", shape, dt, err, passed,
                     lambda: fused("kernel", pk), lambda: fused("torch", pt),
                     PA.paged_cost_bytes(q, kp, lengths, written_rows=True),
                     flops + 12 * (h + hk) * b * d, None,
                     tol + "; written pages, codes, scales bitwise",
                     ops_per_s=peak, iters=20)
        rows_out[-1]["sdpa_dense_ms"] = t_sd[0]
        del pk, pt, out_k, out_t
    torch.cuda.empty_cache()
    return ok


def _envelope_checks(torch, g):
    """Shapes outside the kernels' envelope (ROADMAP C-8): head_dim 36,
    which the JAX package also sends to its composition, through
    ``fused_attention``, ``paged_attention`` and ``paged_decode_fused``,
    and head_dim 264, above the port's 256, through ``fused_attention``.
    Under ``"auto"`` on the card each must log its route ("falling back
    to the plain composition"), launch no kernel, and return what
    ``implementation="torch"`` returns, bitwise (for the fused step also
    the written pages)."""
    import importlib
    import logging

    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.ops.rope import rope_cos_sin
    PA = importlib.import_module("apex_tpu_torch.ops.paged_attention")

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    lines = []

    class Catch(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("apex_tpu_torch.ops")
    catch, level = Catch(), logger.level
    logger.addHandler(catch)
    logger.setLevel(logging.INFO)

    def check(tag, auto, plain):
        lines.clear()
        before = dict(_build.launches)
        got, ref = auto(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        op = tag.split("/")[0]
        logged = [x for x in lines if x.startswith(op + ": falling back")]
        quiet = _build.launches == before
        log(f"  envelope {tag}: log {logged[:1]}; no launch {quiet}; equal "
            f"to the plain version {same}")
        return bool(logged) and quiet and same

    ok = True
    try:
        for d in (36, 264):
            q, k, v = (torch.randn(2, 40, 4, d, generator=g, device=dev).to(
                bf16) for _ in range(3))
            ok &= check(f"fused_attention/d{d}",
                        lambda: (A.fused_attention(q, k, v, causal=True),),
                        lambda: (A.fused_attention(q, k, v, causal=True,
                                                   implementation="torch"),))
        d, lengths = 36, [40, 17, 0, 33]
        kp, vp, tables, lens, _ = _paged_pool(
            torch, g, dev, b=4, hk=8, d=d, bs=16, lengths=lengths, s=1,
            dtype=bf16)
        q = torch.randn(4, 1, 8, d, generator=g, device=dev).to(bf16)
        args = (q, kp, vp, tables, lens)
        ok &= check("paged_attention/d36",
                    lambda: (PA.paged_attention(*args),),
                    lambda: (PA.paged_attention(*args,
                                                implementation="torch"),))
        cos_t, sin_t = rope_cos_sin(4096, d, device=dev)
        pos = lens.long()
        kw = dict(max_seq_len=4096, cos_b=cos_t[pos][:, None, None, :],
                  sin_b=sin_t[pos][:, None, None, :])
        nk, nv = (torch.randn(4, 1, 8, d, generator=g, device=dev).to(bf16)
                  for _ in range(2))

        def fused(impl):
            return PA.paged_decode_fused(q, nk, nv, kp.clone(), vp.clone(),
                                         tables, lens, implementation=impl,
                                         **kw)
        ok &= check("paged_decode_fused/d36", lambda: fused(None),
                    lambda: fused("torch"))
    finally:
        logger.removeHandler(catch)
        logger.setLevel(level)
    return ok


def _close_rel(torch, got, ref, rel):
    """``(max |got - ref|, passed)``: passed when the largest difference
    is within ``rel`` of the reference's largest magnitude."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err <= rel * max(scale, 1e-30)


def _packed_qk(torch, g, b, s, h, hk, d, dt, grouped=True):
    """q and k as ``ParallelAttention._qkv`` views them in a packed
    ``(b, s, (h + 2 hk) d)`` projection: in the grouped layout q is the
    ``(b, s, hk, h / hk, d)`` view, in the flat one ``(b, s, h, d)``."""
    dev = torch.device("cuda")
    qkv = torch.randn(b, s, (h + 2 * hk) * d, generator=g,
                      device=dev).to(dt)
    if grouped:
        rep = h // hk
        gv = qkv.view(b, s, hk, rep + 2, d)
        return qkv, gv[..., :rep, :], gv[..., rep, :]
    return (qkv, qkv[..., :h * d].view(b, s, h, d),
            qkv[..., h * d:(h + hk) * d].view(b, s, hk, d))


def _rope_qk_rows(torch, g, record, cos_t, sin_t):
    """``_rope_qk`` — q and k read from the packed projection and rotated
    in one launch, as the model calls it — at the chunked-prefill step's
    shape (8 slots x 128 tokens, Llama-2-7B's 32 heads at d 128, bf16,
    per-row tables) and the dense decode step's (4 x 1), against the
    plain version bit for bit; then its backward alone at the chunk shape
    (dq and dk by -theta, one launch), and the one-operand backward
    alone at the prefill shape (1, 512, 32, 128).  Bound: each operand
    read and written once, the tables read once."""
    from apex_tpu_torch.ops.rope import (
        _rope_kernel, _rope_pair, _rope_qk, rope_reference)

    dev = torch.device("cuda")
    ok = True
    for b_, s_ in ((8, 128), (4, 1)):
        _, q, k = _packed_qk(torch, g, b_, s_, 32, 32, 128, torch.bfloat16)
        pos = torch.randint(0, 4096 - s_, (b_, 1), generator=g,
                            device=dev) + torch.arange(s_, device=dev)
        c, sn = cos_t[pos], sin_t[pos]
        q4 = q.reshape(b_, s_, 32, 128)

        def kern(): return _rope_qk(q, k, c, sn)
        def plain(): return rope_reference(q4, c, sn), rope_reference(k, c, sn)
        (yq, yk), (rq, rk) = kern(), plain()
        torch.cuda.synchronize()
        passed = torch.equal(yq, rq) and torch.equal(yk, rk)
        err = max(float((yq.float() - rq.float()).abs().max()),
                  float((yk.float() - rk.float()).abs().max()))
        n = q.numel() + k.numel()
        ok &= record("rope/qk", (b_, s_, 32, 128), torch.bfloat16, err,
                     passed, kern, plain, 2 * n * 2 + 2 * c.numel() * 4,
                     3 * n, None, "bitwise; q and k in one launch, read "
                     "through their strides from the packed projection")
        if s_ == 1:
            continue
        dq = torch.randn(yq.shape, generator=g, device=dev).to(torch.bfloat16)
        dk = torch.randn(yk.shape, generator=g, device=dev).to(torch.bfloat16)

        def kern_b(): return _rope_pair(dq, dk, c, sn, -1.0, True)
        def plain_b(): return _rope_pair(dq, dk, c, sn, -1.0, False)
        (gq, gk), (pq, pk) = kern_b(), plain_b()
        torch.cuda.synchronize()
        passed = torch.equal(gq, pq) and torch.equal(gk, pk)
        err = max(float((gq.float() - pq.float()).abs().max()),
                  float((gk.float() - pk.float()).abs().max()))
        ok &= record("rope/qk_bwd", (b_, s_, 32, 128), torch.bfloat16, err,
                     passed, kern_b, plain_b, 2 * n * 2 + 2 * c.numel() * 4,
                     3 * n, None, "bitwise; dq and dk in one launch")
    c, sn = cos_t[:512], sin_t[:512]
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 512, 32, 128, generator=g, device=dev).to(dt)
        dy = torch.randn(x.shape, generator=g, device=dev).to(dt)

        def grad_of(impl):
            from apex_tpu_torch.ops.rope import fused_rope
            xr = x.detach().requires_grad_()
            y = fused_rope(xr, c, sn, implementation=impl)
            return torch.autograd.grad(y, xr, dy)[0]
        got, ref = grad_of("kernel"), grad_of("torch")
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        nbytes = 2 * x.numel() * x.element_size() + 2 * c.numel() * 4
        ok &= record("rope/bwd", tuple(x.shape), dt, err,
                     torch.equal(got, ref),
                     lambda: _rope_kernel(dy, c, sn, -1.0),
                     lambda: rope_reference(dy, c, -sn),
                     nbytes, 3 * x.numel(), None,
                     "bitwise (through autograd); timed: the backward "
                     "alone")
    return ok


def _rope_edge_checks(torch, g):
    """The RoPE kernel on the card at its edges, each against the plain
    version bit for bit, forward and backward (sign -1), ``_rope_qk``
    against two ``fused_rope`` calls too: both qkv layouts, GQA 32/8 and
    4/1, shared and per-row tables, a partial rotary span (rot 64 of d
    128; rot 48 of d 80, whose tail is four vectors, at 8 x 160
    positions: blocks of several positions), d 8, 72 (a span of
    36, not whole vectors: one element a thread), 256, fp32, bf16 and
    fp16, a view one element off 16-byte alignment, and a 3-D (s, h, d)
    input."""
    from apex_tpu_torch.ops.rope import (
        _rope_pair, _rope_qk, fused_rope, rope_cos_sin, rope_reference)

    dev = torch.device("cuda")
    cases = [  # b, s, h, hk, d, rot, dtype, per_row, grouped
        (2, 33, 32, 8, 128, 128, torch.bfloat16, True, True),
        (2, 33, 32, 8, 128, 128, torch.float16, False, False),
        (3, 5, 4, 1, 128, 64, torch.float32, True, True),
        (8, 160, 6, 2, 80, 48, torch.bfloat16, False, True),
        (2, 9, 4, 4, 8, 8, torch.float32, True, False),
        (1, 17, 8, 2, 72, 72, torch.bfloat16, True, True),
        (2, 3, 16, 16, 256, 256, torch.float16, False, True),
    ]
    ok = True
    for b_, s_, h, hk, d, rot, dt, per_row, grouped in cases:
        ct, st = rope_cos_sin(256, rot, device=dev)
        if per_row:
            pos = torch.randint(0, 256 - s_, (b_, 1), generator=g,
                                device=dev) + torch.arange(s_, device=dev)
            c, sn = ct[pos], st[pos]
        else:
            c, sn = ct[7:7 + s_], st[7:7 + s_]
        _, q, k = _packed_qk(torch, g, b_, s_, h, hk, d, dt, grouped)
        q4 = q.reshape(b_, s_, h, d)
        good = True
        for sign in (1.0, -1.0):
            yq, yk = _rope_pair(q, k, c, sn, sign, True)
            rq, rk = _rope_pair(q, k, c, sn, sign, False)
            good &= torch.equal(yq, rq) and torch.equal(yk, rk)
        yq, yk = _rope_qk(q, k, c, sn)
        good &= torch.equal(yq, fused_rope(q4, c, sn))
        good &= torch.equal(yk, fused_rope(k, c, sn))
        torch.cuda.synchronize()
        log(f"  rope edge b{b_} s{s_} h{h}/{hk} d{d} rot{rot} "
            f"{str(dt)[6:]} {'per-row' if per_row else 'shared'} "
            f"{'grouped' if grouped else 'flat'}: "
            f"{'bitwise' if good else 'FAIL'}")
        ok &= good
    # one element off 16-byte alignment, and (s, h, d)
    ct, st = rope_cos_sin(64, 128, device=dev)
    base = torch.randn(2, 16, 4, 129, generator=g, device=dev).to(
        torch.bfloat16)
    x = base[..., 1:]
    good = torch.equal(fused_rope(x, ct[:16], st[:16]),
                       rope_reference(x, ct[:16], st[:16]))
    x3 = torch.randn(16, 4, 128, generator=g, device=dev).to(torch.float16)
    good &= torch.equal(fused_rope(x3, ct[:16], st[:16]),
                        rope_reference(x3, ct[:16], st[:16]))
    log(f"  rope edge unaligned view, (s, h, d): "
        f"{'bitwise' if good else 'FAIL'}")
    return ok and good


def _layer_norm_training_rows(torch, g, record):
    """LayerNorm forward with saved statistics and the dx backward at
    the training shapes (b*s = 8192 rows and the 16*80 = 1280 gathered
    MLM rows of BERT-Large), bf16 activations with fp32 weights as under
    amp O2, and fp32; both rerun bitwise at 8192 x 1024 bf16."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as L

    dev = torch.device("cuda")
    ok = True
    for rows in (8192, 1280):
        for dt in (torch.bfloat16, torch.float32):
            h = 1024
            x = (1 + torch.randn(rows, h, generator=g, device=dev)).to(dt)
            w = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
            b = 0.1 * torch.randn(h, generator=g, device=dev)
            dy = torch.randn(rows, h, generator=g, device=dev).to(dt)
            y, mu, rs = L.layer_norm_fwd_kernel(x, w, b, 1e-5, False, True)
            y2, mu2, rs2 = L.layer_norm_stats_reference(x, w, b, 1e-5)
            dx = L.layer_norm_bwd_dx_kernel(dy, x, w, mu, rs, False)
            dx2 = L.layer_norm_bwd_dx_reference(dy, x, w, mu2, rs2, False)
            torch.cuda.synchronize()
            stats_err = max(float((mu - mu2).abs().max()),
                            float(((rs - rs2) / rs2).abs().max()))
            if dt == torch.float32:
                passed_f = bool(torch.allclose(y, y2, rtol=1e-5, atol=1e-5))
                passed_b = bool(torch.allclose(dx, dx2, rtol=1e-4,
                                               atol=1e-4))
                tol_f, tol_b = "rtol 1e-5, atol 1e-5", "rtol 1e-4, atol 1e-4"
            else:
                # x - mean cancels near zero, where an fp32 difference
                # in the mean is more than an ulp of the tiny output
                passed_f = bf16_ulp_ok(torch, y, y2, floor=2 ** -16 * float(
                    y2.float().abs().max()))
                passed_b = _close_rel(torch, dx, dx2, 2 ** -7)[1]
                tol_f = "1 bf16 ulp + 2^-16 of the largest |y|"
                tol_b = "2^-7 of the largest |dx|"
            passed_f &= stats_err <= 1e-5
            if rows == 8192 and dt == torch.bfloat16:
                again = L.layer_norm_fwd_kernel(x, w, b, 1e-5, False, True)
                rerun = all(torch.equal(a, c)
                            for a, c in zip((y, mu, rs), again))
                log(f"  layer_norm/stats {rows}x{h} bf16 rerun bitwise "
                    f"{rerun}")
                passed_f &= rerun
                tol_f += "; rerun bitwise"
            isz = x.element_size()
            err_f = max(float((y.float() - y2.float()).abs().max()),
                        stats_err)
            ok &= record(
                "layer_norm/stats", (rows, h), dt, err_f, passed_f,
                lambda: L.layer_norm_fwd_kernel(x, w, b, 1e-5, False, True),
                lambda: L.layer_norm_stats_reference(x, w, b, 1e-5),
                2 * rows * h * isz + 2 * h * 4 + 8 * rows, 7 * rows * h,
                lambda: F.layer_norm(x, (h,), w.to(dt), b.to(dt), 1e-5),
                tol_f + "; mean/rstd 1e-5")
            if rows == 8192 and dt == torch.bfloat16:
                rerun = torch.equal(
                    dx, L.layer_norm_bwd_dx_kernel(dy, x, w, mu, rs, False))
                log(f"  layer_norm_bwd {rows}x{h} bf16 rerun bitwise "
                    f"{rerun}")
                passed_b &= rerun
                tol_b += "; rerun bitwise"
            xr = x.detach().requires_grad_()
            ylib = F.layer_norm(xr, (h,), w.to(dt), b.to(dt), 1e-5)
            err_b = float((dx.float() - dx2.float()).abs().max())
            ok &= record(
                "layer_norm_bwd", (rows, h), dt, err_b, passed_b,
                lambda: L.layer_norm_bwd_dx_kernel(dy, x, w, mu, rs, False),
                lambda: L.layer_norm_bwd_dx_reference(dy, x, w, mu, rs,
                                                      False),
                3 * rows * h * isz + h * 4 + 8 * rows, 10 * rows * h,
                lambda: torch.autograd.grad(ylib, xr, dy,
                                            retain_graph=True),
                tol_b)
    return ok


def _batch_norm_rows(torch, g, record):
    """The four BatchNorm passes against their plain versions at the
    ResNet-50 b=128 path's shapes: stage 0's last BN (128x56x56 rows,
    C = 256) with residual and ReLU in bf16 and fp32, and the stem's
    (128x112x112 rows, C = 64) with ReLU in bf16.  B-12 and B-14 within
    1e-5 of the per-channel sum of the terms' magnitudes (fp32 sums in
    another order); B-13 and B-15 bitwise on the same per-channel
    vectors; every kernel's bf16 rerun bitwise equal to its first run.
    The library yardstick is ``F.batch_norm`` in training mode on the
    same channels_last tensor: forward for the pair B-12 + B-13,
    forward and backward for B-14 + B-15 (it has no add and ReLU
    epilogue)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import batch_norm as B

    dev = torch.device("cuda")
    cases = [  # tag, (n, h, w, c), dtype, residual
        ("bn3", (128, 56, 56, 256), torch.bfloat16, True),
        ("stem", (128, 112, 112, 64), torch.bfloat16, False),
        ("bn3", (128, 56, 56, 256), torch.float32, True),
    ]
    ok = True
    for tag, (n, h, w_, c), dt, has_res in cases:
        rows = n * h * w_
        x = (0.5 + torch.randn(rows, c, generator=g, device=dev)).to(dt)
        res = (torch.randn(rows, c, generator=g, device=dev).to(dt)
               if has_res else None)
        dy = torch.randn(rows, c, generator=g, device=dev).to(dt)
        wt = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
        bt = 0.1 * torch.randn(c, generator=g, device=dev)
        isz, ec = x.element_size(), rows * c
        vec_bytes = 4 * c                      # one fp32 (C,) vector

        # B-12, and the per-channel vectors of the plain statistics
        got = B.bn_reduce_kernel(x)
        again = B.bn_reduce_kernel(x)
        ref = B.bn_reduce_reference(x)
        xf = x.float()
        scale_1 = xf.abs().sum(0)
        mean = ref[0] / rows
        rstd = torch.rsqrt(torch.clamp_min(ref[1] / rows - mean * mean, 0.0)
                           + 1e-5)
        scale, shift = rstd * wt, bt - mean * rstd * wt
        scale_2 = (dy.float() * ((xf - mean) * rstd)).abs().sum(0)
        dy_1 = dy.float().abs().sum(0)
        del xf
        torch.cuda.synchronize()
        rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        passed = (bool(((got[0] - ref[0]).abs() <= 1e-5 * scale_1).all())
                  and bool(((got[1] - ref[1]).abs() <= 1e-5 * ref[1]).all())
                  and rerun)
        tol = "1e-5 of the per-channel sum of |term|; rerun bitwise"
        x4 = x.view(n, h, w_, c).permute(0, 3, 1, 2)
        dy4 = dy.view(n, h, w_, c).permute(0, 3, 1, 2)
        wl, bl = wt.to(dt), bt.to(dt)

        def lib_fwd():
            return F.batch_norm(x4, None, None, wl, bl, training=True)

        def lib_fwd_bwd():
            xr = x4.detach().requires_grad_()
            out = F.batch_norm(xr, None, None, wl, bl, training=True)
            return torch.autograd.grad(out, xr, dy4)
        shape = (rows, c)
        log(f"  bn {tag} {shape} {str(dt)[6:]}: reduce rerun bitwise "
            f"{rerun}")
        ok &= record("bn_reduce", shape, dt, err, passed,
                     lambda: B.bn_reduce_kernel(x),
                     lambda: B.bn_reduce_reference(x),
                     ec * isz + 2 * vec_bytes, 3 * ec, lib_fwd,
                     tol + "; library: F.batch_norm forward (pair 12+13)",
                     iters=20)

        # B-13
        y = B.bn_apply_kernel(x, res, scale, shift, True)
        y_again = B.bn_apply_kernel(x, res, scale, shift, True)
        y_ref = B.bn_apply_reference(x, res, scale, shift, True)
        torch.cuda.synchronize()
        err = float((y.float() - y_ref.float()).abs().max())
        rerun = torch.equal(y, y_again)
        passed = torch.equal(y, y_ref) and rerun
        log(f"  bn {tag} apply: bitwise {torch.equal(y, y_ref)}, rerun "
            f"bitwise {rerun}")
        ok &= record("bn_apply", shape, dt, err, passed,
                     lambda: B.bn_apply_kernel(x, res, scale, shift, True),
                     lambda: B.bn_apply_reference(x, res, scale, shift,
                                                  True),
                     (2 + has_res) * ec * isz + 2 * vec_bytes,
                     (3 + has_res) * ec, lib_fwd,
                     "bitwise; rerun bitwise; library: F.batch_norm "
                     "forward (pair 12+13)", iters=20)
        del y_again

        # B-14: the ReLU mask from y with a residual, else from the affine
        ys = y_ref if has_res else None
        scsh = None if has_res else (scale, shift)
        args = (dy, x, ys, scsh, mean, rstd, True)
        got = B.bn_bwd_reduce_kernel(*args)
        again = B.bn_bwd_reduce_kernel(*args)
        ref = B.bn_bwd_reduce_reference(*args)
        torch.cuda.synchronize()
        rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        passed = (bool(((got[0] - ref[0]).abs() <= 1e-5 * dy_1).all())
                  and bool(((got[1] - ref[1]).abs() <= 1e-5 * scale_2).all())
                  and rerun)
        log(f"  bn {tag} bwd reduce: rerun bitwise {rerun}")
        mask_ops = 1 if has_res else 3
        ok &= record("bn_bwd_reduce", shape, dt, err, passed,
                     lambda: B.bn_bwd_reduce_kernel(*args),
                     lambda: B.bn_bwd_reduce_reference(*args),
                     (2 + has_res) * ec * isz + 4 * vec_bytes,
                     (mask_ops + 5) * ec, lib_fwd_bwd,
                     "1e-5 of the per-channel sum of |dy| and |dy*xhat|; "
                     "rerun bitwise; library: F.batch_norm forward + "
                     "backward (pair 14+15)", iters=20)

        # B-15 with the plain coefficients (no mean/var cotangents)
        a = rstd * wt
        cb, cc = -(a * ref[0]) / rows, -(a * ref[1]) / rows
        dargs = args[:-1] + (a, cb, cc, True, has_res)
        dx, dres = B.bn_bwd_dx_kernel(*dargs)
        dx2, dres2 = B.bn_bwd_dx_kernel(*dargs)
        dx_ref, dres_ref = B.bn_bwd_dx_reference(*dargs)
        torch.cuda.synchronize()
        same = torch.equal(dx, dx_ref) and (
            not has_res or torch.equal(dres, dres_ref))
        rerun = torch.equal(dx, dx2) and (
            not has_res or torch.equal(dres, dres2))
        err = float((dx.float() - dx_ref.float()).abs().max())
        log(f"  bn {tag} dx: bitwise {same}, rerun bitwise {rerun}")
        ok &= record("bn_bwd_dx", shape, dt, err, same and rerun,
                     lambda: B.bn_bwd_dx_kernel(*dargs),
                     lambda: B.bn_bwd_dx_reference(*dargs),
                     (3 + 2 * has_res) * ec * isz + 7 * vec_bytes,
                     (mask_ops + 6) * ec, lib_fwd_bwd,
                     "bitwise; rerun bitwise; library: F.batch_norm "
                     "forward + backward (pair 14+15)", iters=20)
        del x, res, dy, y, y_ref, dx, dx2, dx_ref, dres, dres2, dres_ref
        del x4, dy4, ys, args, dargs
        torch.cuda.empty_cache()
    return ok


def _fp8_bytes(lay):
    """Bytes one fp8 Adam step must move over ``lay`` (fp32 g and p):
    g read, p read and written (4 B each) for every element; both
    moments' codes read and written (1 B each) and their fp32 scales
    read and written, over the padded state."""
    return 12 * lay.numel + 4 * lay.total + 16 * (lay.total // 256)


def _fp8_state_bytes(st, p):
    """Every tensor of a one-buffer fp8 state and its params, as raw
    bytes: what a skipped step must leave unchanged, and what the kernel
    and the plain version must agree on."""
    import torch
    return [t.reshape(-1).view(torch.uint8) for t in (
        p, st.exp_avg[0].q, st.exp_avg[0].scale, st.exp_avg_sq[0].q,
        st.exp_avg_sq[0].scale, st.count)]


def _fp8_adam_rows(torch, g, record):
    """B-18 against its plain version on the card: three steps through
    ``FusedAdam.step`` on the kernel and the plain path, params, codes
    and scales compared bitwise after each step, at BERT-Large's layout
    (every parameter a leaf, the linear weights transposed, 3.36e8
    elements; the main path's one launch per step) and on leaves of 7,
    300 and 16384 + 300 elements beside transposed ones, wd 0 / 0.01 x
    AdamW / L2; a non-finite step changes no byte; a block of ties and
    subnormals (b1 = 0, absmax 448: codes are e4m3 of the gradient) and
    one with a NaN gradient.  Timed on the kernel wrapper itself (one
    launch) against the plain version; no PyTorch call computes it."""
    import importlib

    from apex_tpu_torch.core import parameter_leaves
    from apex_tpu_torch.models import BertConfig, BertModel
    fa = importlib.import_module("apex_tpu_torch.optim.fused_adam")

    dev = torch.device("cuda")
    ok = True
    meta = BertModel(BertConfig.bert_large(dtype=torch.bfloat16, remat=True),
                     device="meta")
    bert = [lf for _, lf in parameter_leaves(meta)]
    small = [fa.Leaf(7), fa.Leaf(300), fa.Leaf(16384 + 300),
             fa.Leaf(300 * 5, (300, 5)), fa.Leaf(512 * 64, (512, 64)),
             fa.Leaf(1024 * 4096, (1024, 4096))]
    cases = [("bert_large", bert, 0.0, True)] + [
        ("small", small, wd, aw) for wd, aw in
        ((0.0, True), (0.01, True), (0.0, False), (0.01, False))]

    def state_pair(leaves, opt, p0):
        out = []
        for _ in range(2):
            p = p0.clone()
            out.append((p, opt.init([p], [leaves])))
        return out

    for tag, leaves, wd, aw in cases:
        lay = fa.Fp8Layout(leaves)
        opt = fa.fused_adam(1e-3, weight_decay=wd, adam_w_mode=aw,
                            moment_format="fp8_block_scaled")
        p0 = torch.randn(lay.numel, generator=g, device=dev)
        (pk, sk), (pt, st) = state_pair(leaves, opt, p0)
        same, diffs = True, []
        for i in range(3):
            gr = 1e-3 * torch.randn(lay.numel, generator=g, device=dev)
            opt.step([gr], sk, [pk], implementation="kernel")
            opt.step([gr], st, [pt], implementation="torch")
            torch.cuda.synchronize()
            d = [int((a != b).sum()) for a, b in zip(
                _fp8_state_bytes(sk, pk), _fp8_state_bytes(st, pt))]
            diffs.append(d)
            same &= not any(d)
        # a non-finite step writes nothing
        before = [t.clone() for t in _fp8_state_bytes(sk, pk)]
        opt.step([gr], sk, [pk], finite=torch.tensor(False, device=dev),
                 implementation="kernel")
        torch.cuda.synchronize()
        skipped = all(torch.equal(a, b) for a, b in
                      zip(before, _fp8_state_bytes(sk, pk)))
        del before
        log(f"  fp8_adam {tag} wd={wd} adamw={aw}: differing bytes of "
            f"(p, m codes, m scales, v codes, v scales, count) per step "
            f"{diffs}; non-finite step unchanged {skipped}")
        passed = same and skipped
        err = float((pk - pt).abs().max())
        if tag == "bert_large":
            sc = torch.tensor([1e-3, 0.1, 0.001], device=dev)
            gr = 1e-3 * torch.randn(lay.numel, generator=g, device=dev)
            m, v = sk.exp_avg[0], sk.exp_avg_sq[0]
            hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
                      adam_w_mode=aw)
            ok &= record(
                "fp8_adam/bert_large", (lay.numel,), torch.float32, err,
                passed,
                lambda: fa.fp8_adam_kernel(gr, pk, m, v, lay, sc, None, **hp),
                lambda: fa.fp8_adam_reference(gr, pt, st.exp_avg[0],
                                              st.exp_avg_sq[0], lay, sc,
                                              None, **hp),
                _fp8_bytes(lay), 25 * lay.numel, None,
                "bitwise (params, codes, scales, count); library: none "
                "(no PyTorch call computes an fp8 block-scaled Adam step)",
                iters=10)
        else:
            ok &= passed
        del pk, pt, sk, st, p0
        torch.cuda.empty_cache()

    # the conversion at its edges, through the kernel: b1 = 0 makes the
    # new first moment the gradient itself, and a 448 in the block makes
    # its scale 1, so the codes are e4m3 of the gradient's values
    edge = torch.tensor([448.0, 1.0625, 1.1875, -1.0625, 2.0 ** -10,
                         2.0 ** -11, 0.75 * 2.0 ** -9, 3 * 2.0 ** -10,
                         -0.0, 432.0, 440.0, 1e-3, 2.0 ** -9 * 1.5,
                         -448.0, 0.0, 17.0], device=dev)
    leaves = [fa.Leaf(256), fa.Leaf(256)]
    gr = torch.zeros(512, device=dev)
    gr[:16] = edge
    gr[256:] = 1e-3 * torch.randn(256, generator=g, device=dev)
    gr[300] = float("nan")
    opt = fa.fused_adam(1e-3, b1=0.0, moment_format="fp8_block_scaled")
    (pk, sk), (pt, st) = state_pair(leaves, opt, torch.zeros(512, device=dev))
    opt.step([gr], sk, [pk], implementation="kernel")
    opt.step([gr], st, [pt], implementation="torch")
    torch.cuda.synchronize()
    d = [int((a != b).sum()) for a, b in zip(_fp8_state_bytes(sk, pk),
                                             _fp8_state_bytes(st, pt))]
    want = edge.to(torch.float8_e4m3fn).view(torch.uint8)
    codes = sk.exp_avg[0].q.view(torch.uint8)[:16]
    log(f"  fp8_adam edge codes {codes.tolist()} (torch's "
        f"{want.tolist()}); differing bytes {d}")
    ok &= not any(d) and torch.equal(codes[:8], want[:8]) and torch.equal(
        codes[9:], want[9:])        # -0.0 enters the moment as +0
    return ok


def _softmax_rows(torch, g, record):
    """B-4 / B-5 against their plain versions on the card at the two
    main-path shapes — BERT-Large scores (16, 16, 512, 512) bf16 with a
    key-padding mask (16, 1, 1, 512), and Megatron GPT's causal
    (4, 16, 1024, 1024) bf16, scale 0.125 — then fp32 and fp16, ``sq <
    sk`` causal, a ragged ``sk`` (77) with a (sq, sk) mask, a fully
    masked row and a 2000-wide row (the streamed path).  Where ``sk % 128
    != 0`` the backward takes the mask and the causal flag and must give
    dx = 0 at every masked position, on a fully masked row at sk = 77
    too (the ``where`` gradient the JAX dispatch takes there); at sk =
    128 the fully masked row keeps the kernel formula.  fp32 within
    2e-6, half types within one ulp; the backward from the same saved y,
    plus what the other order of its row sum moves dx by (where ``dy -
    sum(dy*y)`` cancels, that outweighs an ulp of dx).
    The backward reruns bitwise at every case.
    Yardsticks: ``torch.softmax`` and its backward
    (``_softmax_backward_data``) on the same tensor — no scale, no mask,
    so they cover part of the function only."""
    from apex_tpu_torch.ops import softmax as S

    dev = torch.device("cuda")
    mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
    sub = {torch.float32: 2.0 ** -149, torch.bfloat16: 2.0 ** -133,
           torch.float16: 2.0 ** -24}

    def close(got, ref, dt, extra=0.0):
        """fp32 within 2e-6, half types within one ulp, plus ``extra``."""
        if dt == torch.float32:
            return bool(((got - ref).abs() <= 2e-6 + extra).all())
        r = ref.float().abs().clamp_min(1e-38)
        ulp = torch.exp2(torch.floor(torch.log2(r)) - mant[dt]).clamp_min(
            sub[dt])
        return bool(((got.float() - ref.float()).abs() <= ulp + extra).all())

    def sum_order(dy, y, scale):
        """What summing ``dy * y`` in another order moves ``dx`` by: a
        tree of sk terms errs by at most log2(sk) roundings of the sum of
        their magnitudes, twice for two trees, carried through ``* y *
        scale`` — it outweighs an ulp of dx where ``dy - sum`` cancels."""
        sk = dy.shape[-1]
        mag = (dy.float() * y.float()).abs().sum(-1, keepdim=True)
        return (2 * math.ceil(math.log2(sk)) * 2.0 ** -24 * mag
                * y.float().abs() * scale)

    cases = [  # tag, shape, mask shape, causal, dtype, recorded
        ("bert", (16, 16, 512, 512), (16, 1, 1, 512), False,
         torch.bfloat16, True),
        ("gpt_causal", (4, 16, 1024, 1024), None, True, torch.bfloat16,
         True),
        ("bert", (16, 16, 512, 512), (16, 1, 1, 512), False,
         torch.float32, False),
        ("sq<sk", (2, 8, 64, 320), None, True, torch.float16, False),
        ("sq<sk", (2, 8, 64, 320), None, True, torch.float32, False),
        ("ragged", (3, 2, 16, 77), (16, 77), False, torch.bfloat16, False),
        ("full_row", (2, 4, 16, 128), (2, 1, 16, 128), False,
         torch.float16, False),
        ("ragged_full_row", (2, 4, 16, 77), (2, 1, 16, 77), False,
         torch.float32, False),
        ("ragged_full_row", (2, 4, 16, 77), (2, 1, 16, 77), False,
         torch.bfloat16, False),
        ("long", (1, 4, 8, 2000), (1, 1, 8, 2000), True, torch.bfloat16,
         False),
    ]
    ok = True
    for tag, shape, ms, causal, dt, main in cases:
        x = (3 * torch.randn(shape, generator=g, device=dev)).to(dt)
        dy = torch.randn(shape, generator=g, device=dev).to(dt)
        m = None if ms is None else torch.rand(
            ms, generator=g, device=dev) < 0.3
        if tag in ("full_row", "ragged_full_row"):
            m[0, 0, 3] = True
        # the where() gradient (zeros at masked positions) at the widths
        # where the JAX dispatch differentiates the reference composition
        zero = shape[-1] % 128 != 0
        bm, bc = (m, causal) if zero else (None, False)
        y = S.softmax_fwd_kernel(x, m, 0.125, causal)
        yp = S.scale_mask_softmax_reference(x, m, 0.125, causal)
        dx = S.softmax_bwd_kernel(dy, yp, 0.125, bm, bc)
        dxp = S.softmax_bwd_reference(dy, yp, 0.125, bm, bc)
        torch.cuda.synchronize()
        ef = float((y.float() - yp.float()).abs().max())
        eb = float((dx.float() - dxp.float()).abs().max())
        pf = close(y, yp, dt)
        pb = close(dx, dxp, dt, sum_order(dy, yp, 0.125))
        if tag == "full_row":
            pf &= bool(torch.allclose(y[0, 0, 3].float(), torch.full(
                (128,), 1 / 128, device=dev), rtol=0, atol=1e-3))
        if zero and (bm is not None or bc):
            dead = S._masked(shape, bm, bc, dev).expand(shape)
            pb &= bool((dx[dead] == 0).all()) and bool((dxp[dead] == 0).all())
        if tag == "ragged_full_row":
            pb &= bool((dx[0, 0, 3] == 0).all())
        # B-5 reruns bitwise everywhere
        rerun_b = torch.equal(dx, S.softmax_bwd_kernel(dy, yp, 0.125, bm, bc))
        pb &= rerun_b
        tol = "2e-6" if dt == torch.float32 else "1 ulp"
        if main:
            # B-4 reruns bitwise at the main-path shapes
            rerun = torch.equal(y, S.softmax_fwd_kernel(x, m, 0.125, causal))
            log(f"  softmax {tag} {shape} {str(dt)[6:]}: rerun bitwise "
                f"fwd {rerun}, bwd {rerun_b}")
            pf &= rerun
        if not main:
            log(f"  softmax {tag} {shape} {str(dt)[6:]}: fwd err {ef:.3g} "
                f"{'ok' if pf else 'FAIL'}, bwd err {eb:.3g} "
                f"{'ok' if pb else 'FAIL'} ({tol})")
            ok &= pf and pb
            continue
        n, isz = x.numel(), x.element_size()
        mbytes = 0 if m is None else m.numel()
        ok &= record(f"softmax_fwd/{tag}", shape, dt, ef, pf,
                     lambda: S.softmax_fwd_kernel(x, m, 0.125, causal),
                     lambda: S.scale_mask_softmax_reference(x, m, 0.125,
                                                            causal),
                     2 * n * isz + mbytes, 6 * n,
                     lambda: torch.softmax(x, -1),
                     tol + "; library: torch.softmax (no scale, no mask)",
                     iters=20)
        ok &= record(f"softmax_bwd/{tag}", shape, dt, eb, pb,
                     lambda: S.softmax_bwd_kernel(dy, yp, 0.125),
                     lambda: S.softmax_bwd_reference(dy, yp, 0.125),
                     3 * n * isz, 4 * n,
                     lambda: torch.ops.aten._softmax_backward_data(
                         dy, yp, -1, dt),
                     tol + " + the row sum's order bound, from the same y; "
                     "library: torch's softmax backward "
                     "(_softmax_backward_data, no scale)",
                     iters=20)
        del x, dy, y, yp, dx, dxp
        torch.cuda.empty_cache()
    return ok


def _group_norm_rows(torch, g, record):
    """B-16 / B-17 against their plain versions on the card: the main
    shape (8, 64x64, 512), 32 groups, SiLU, fp32 affine, in bf16 and fp32,
    which must take the cluster route (one ``group_norm_fwd`` and one
    ``group_norm_bwd`` launch); a VAE decoder's (1, 512x512, 128) bf16,
    whose slab no cluster holds, on the three-pass route
    (``group_norm_fwd_3pass`` / ``group_norm_bwd_3pass``); SD-1.5's C =
    320 (cg = 10); odd spatial (3, 7, 9, 96) with 3 groups; no affine and
    no activation; the 2-D (N, C) case; a mean offset of 100 in fp32.
    The backward runs from the plain version's statistics.  Tolerances:
    fp32 y and dx within 2e-5; half types within one ulp plus 2^-16 of
    the largest magnitude (near zero the fp32 values' last bits outweigh
    an ulp of the tiny result); mean within 1e-6 of max(|mean|, 1), rstd
    within 1e-5 relative; dγ, dβ within 2e-5 of their largest entry (sums
    over the batch in another order).  The bf16 main and VAE rows are run
    twice: y, the statistics, dx, dγ and dβ bitwise equal, on both routes.
    Yardstick: ``F.silu(F.group_norm(x, 32, w, b))`` on an NCHW-contiguous
    copy of the same data (the copy untimed) — forward, and forward +
    backward for B-17's row; the port never calls it."""
    import torch.nn.functional as F

    from apex_tpu_torch import _build
    from apex_tpu_torch.ops.group_norm import (
        group_norm_bwd_kernel, group_norm_bwd_reference,
        group_norm_fwd_kernel, group_norm_fwd_reference)

    dev = torch.device("cuda")
    cluster = {"group_norm_fwd": 1, "group_norm_bwd": 1}
    three = {"group_norm_fwd_3pass": 1, "group_norm_bwd_3pass": 1}
    cases = [  # tag, shape, groups, silu, affine, dtype, offset, recorded,
        # the launches of one forward and backward (None: either route)
        ("main", (8, 64, 64, 512), 32, True, True, torch.bfloat16, 0.0, True,
         cluster),
        ("main", (8, 64, 64, 512), 32, True, True, torch.float32, 0.0, True,
         cluster),
        ("vae", (1, 512, 512, 128), 32, True, True, torch.bfloat16, 0.0,
         True, three),
        ("c320", (8, 32, 32, 320), 32, True, True, torch.bfloat16, 0.0,
         False, three),
        ("odd", (3, 7, 9, 96), 3, True, True, torch.float32, 0.0, False,
         None),
        ("plain_norm", (8, 32, 32, 512), 32, False, False, torch.bfloat16,
         0.0, False, None),
        ("2d", (64, 512), 32, True, True, torch.float32, 0.0, False, None),
        ("offset100", (8, 64, 64, 512), 32, True, True, torch.float32, 100.0,
         False, cluster),
    ]
    ok = True
    for tag, shape, grp, silu, affine, dt, off, main, expect in cases:
        c = shape[-1]
        x = (off + torch.randn(shape, generator=g, device=dev)).to(dt)
        dy = torch.randn(shape, generator=g, device=dev).to(dt)
        w = b = None
        if affine:
            w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
            b = 0.1 * torch.randn(c, generator=g, device=dev)
        x3 = x.view(shape[0], -1, c)
        dy3 = dy.view(x3.shape)
        fargs = (x3, w, b, grp, 1e-5, silu)
        _build.reset_launches()
        y, mean, rstd = group_norm_fwd_kernel(*fargs)
        y_p, mean_p, rstd_p = group_norm_fwd_reference(*fargs)
        bargs = (dy3, x3, w, b, mean_p, rstd_p, grp, silu)
        dx, dw, db = group_norm_bwd_kernel(*bargs)
        fired = {k: v for k, v in _build.launches.items() if v}
        dx_p, dw_p, db_p = group_norm_bwd_reference(*bargs)
        rerun = True
        if main and dt != torch.float32:
            again = group_norm_fwd_kernel(*fargs) + group_norm_bwd_kernel(
                *bargs)
            rerun = all(torch.equal(a, r) for a, r in zip(
                again, (y, mean, rstd, dx, dw, db)))
        torch.cuda.synchronize()
        routed = expect is None or fired == expect

        def close(got, ref):
            if dt == torch.float32:
                return bool(((got - ref).abs() <= 2e-5).all())
            return bf16_ulp_ok(torch, got, ref, floor=2 ** -16 * float(
                ref.float().abs().max()))
        stats_ok = (bool(((mean - mean_p).abs() <= 1e-6 * torch.clamp_min(
            mean_p.abs(), 1.0)).all())
            and bool(((rstd - rstd_p).abs() <= 1e-5 * rstd_p).all()))
        pf = close(y, y_p) and stats_ok and rerun and routed
        red = all(float((a - r).abs().max()) <= 2e-5 * float(r.abs().max())
                  for a, r in ((dw, dw_p), (db, db_p)))
        pb = close(dx, dx_p) and red and rerun and routed
        ef = max(float((y.float() - y_p.float()).abs().max()),
                 float((mean - mean_p).abs().max()))
        eb = max(float((dx.float() - dx_p.float()).abs().max()),
                 float((dw - dw_p).abs().max()),
                 float((db - db_p).abs().max()))
        half = "1 ulp + 2^-16 of max|.|"
        tol = ("2e-5" if dt == torch.float32 else half) + (
            "; mean 1e-6 of max(|mean|, 1), rstd 1e-5 relative; dγ, dβ "
            "2e-5 of the largest entry")
        log(f"  group_norm {tag} {shape} {str(dt)[6:]}: launches {fired}"
            f"{'' if routed else ' (expected ' + str(expect) + ')'}, "
            f"fwd err {ef:.3g} {'ok' if pf else 'FAIL'}, bwd err {eb:.3g} "
            f"{'ok' if pb else 'FAIL'}" + (f", rerun bitwise {rerun}"
                                           if main else ""))
        if not main:
            ok &= pf and pb
            continue
        n, isz = x.numel(), x.element_size()
        stat_bytes = 2 * shape[0] * grp * 4
        wl = w.to(dt)
        bl = b.to(dt)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        dy_nchw = dy.permute(0, 3, 1, 2).contiguous()

        def lib_fwd():
            return F.silu(F.group_norm(x_nchw, grp, wl, bl, 1e-5))

        def lib_fwd_bwd():
            xr, wr, br = (t.detach().requires_grad_()
                          for t in (x_nchw, wl, bl))
            out = F.silu(F.group_norm(xr, grp, wr, br, 1e-5))
            return torch.autograd.grad(out, (xr, wr, br), dy_nchw)
        route = "" if tag == "main" else "_3pass"
        ok &= record(f"group_norm_fwd{route}/{tag}", tuple(x3.shape), dt, ef,
                     pf, lambda: group_norm_fwd_kernel(*fargs),
                     lambda: group_norm_fwd_reference(*fargs),
                     2 * n * isz + 2 * c * 4 + stat_bytes, 12 * n, lib_fwd,
                     tol + "; library: F.silu(F.group_norm) forward, NCHW",
                     iters=20, extra=dict(launches=fired))
        ok &= record(f"group_norm_bwd{route}/{tag}", tuple(x3.shape), dt, eb,
                     pb, lambda: group_norm_bwd_kernel(*bargs),
                     lambda: group_norm_bwd_reference(*bargs),
                     3 * n * isz + 4 * c * 4 + stat_bytes, 20 * n,
                     lib_fwd_bwd,
                     tol + "; library: F.silu(F.group_norm) forward + "
                     "backward, NCHW", iters=20, extra=dict(launches=fired))
        del x_nchw, dy_nchw
    torch.cuda.empty_cache()
    return ok


def visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the attention mask leaves visible."""
    if not causal:
        return sq * sk
    off, n = sk - sq, 0
    for q in range(sq):
        hi = min(sk - 1, q + off)
        lo = max(0, q + off - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def _flash_rows(torch, g, record):
    """Flash forward, dq and dk/dv against their plain versions: BERT-
    Large (b=16, s=512, h=16, d=64) plain, with a (b,1,1,s) key-padding
    bias and with dropout 0.1; a causal GQA case with a window at d=128;
    ViT-Huge's (b=32, s=257, h=16, d=80); bf16 and fp32, ViT-Huge fp16
    too.  At BERT bf16 the forward, dq and dk/dv must rerun bitwise, and
    at ViT-Huge bf16 and fp16 (all three on the wgmma kernels at d=80).
    Each row logs and records the route its kernel took (``wgmma`` or
    ``fma``, :func:`flash_route`).  The library yardstick is ``F.scaled_dot_product_attention``
    forward for the forward, and its backward alone (``autograd.grad``
    over a retained forward, CUDA events) for each backward kernel, with
    forward + backward beside it.  Bounds: the forward 2 products, dq 3
    (S, dP, dS·K), dk/dv 4 (S, dP, dV, dK), each over its own bytes."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    cases = [
        ("bert", dict(b=16, s=512, h=16, hk=16, d=64, causal=False,
                      window=None, bias=False, rate=0.0)),
        ("bert/pad", dict(b=16, s=512, h=16, hk=16, d=64, causal=False,
                          window=None, bias=True, rate=0.0)),
        ("bert/drop", dict(b=16, s=512, h=16, hk=16, d=64, causal=False,
                           window=None, bias=False, rate=0.1)),
        ("gqa/window", dict(b=2, s=2048, h=32, hk=8, d=128, causal=True,
                            window=512, bias=False, rate=0.0)),
        # ViT-H/14 at 224: 257 tokens, head dim 80 (the wgmma forward
        # and backward in half types, 16-column panels)
        ("vit_huge", dict(b=32, s=257, h=16, hk=16, d=80, causal=False,
                          window=None, bias=False, rate=0.0)),
    ]
    ok = True
    for tag, c in cases:
        dtypes = (torch.bfloat16, torch.float32) + (
            (torch.float16,) if tag == "vit_huge" else ())
        for dt in dtypes:
            b, s, h, hk, d = c["b"], c["s"], c["h"], c["hk"], c["d"]
            q = torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
            k = torch.randn(b, s, hk, d, generator=g, device=dev).to(dt)
            v = torch.randn(b, s, hk, d, generator=g, device=dev).to(dt)
            do = torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
            bias = None
            if c["bias"]:
                lens = torch.randint(s // 2, s + 1, (b,), generator=g,
                                     device=dev)
                bias = A.mask_to_bias(
                    torch.arange(s, device=dev)[None, :] >= lens[:, None]
                ).view(b, 1, 1, s)
            args = (bias, d ** -0.5, c["causal"], c["window"], c["rate"],
                    20240613)
            o, lse = A.flash_fwd_kernel(q, k, v, *args)
            o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
            delta = A.attention_delta(do, o2)
            bw = (q, k, v, bias, do, lse2, delta) + args[1:]
            dq = A.flash_bwd_dq_kernel(*bw)
            dq2 = A.flash_bwd_dq_reference(*bw)
            dk, dv = A.flash_bwd_dkv_kernel(*bw)
            dk2, dv2 = A.flash_bwd_dkv_reference(*bw)
            torch.cuda.synchronize()
            # fp32: sums in another order; bf16: outputs round to 8 bits.
            # The kernel sums a GQA group in its fp32 accumulators, the
            # plain dk/dv per head and then over the group: an order
            # difference of fp32 sums, inside both bounds
            rel = 1e-5 if dt == torch.float32 else 2 ** -7
            tol = f"max |err| <= {rel:g} x max |ref| per output"
            live = lse2 > -1e29
            e_o, p_o = _close_rel(torch, o, o2, rel)
            e_l, p_l = _close_rel(torch, lse[live], lse2[live], 1e-5)
            e_q, p_q = _close_rel(torch, dq, dq2, rel)
            e_k, p_k = _close_rel(torch, dk, dk2, rel)
            e_v, p_v = _close_rel(torch, dv, dv2, rel)
            p_dead = bool((lse[~live] < -1e29).all())
            route = {kn: A.flash_route(kn, dt, d)
                     for kn in ("fwd", "dq", "dkv")}
            log(f"  flash {tag} {str(dt)[6:]} routes: {route}")
            want = "fma" if dt == torch.float32 else "wgmma"
            if tag == "vit_huge" and set(route.values()) != {want}:
                log(f"  flash vit_huge {str(dt)[6:]}: routes {route}, "
                    f"expected {want} for all three FAIL")
                ok = False
            if (tag == "bert" and dt == torch.bfloat16) or (
                    tag == "vit_huge" and dt != torch.float32):
                o3, lse3 = A.flash_fwd_kernel(q, k, v, *args)
                dq3 = A.flash_bwd_dq_kernel(*bw)
                dk3, dv3 = A.flash_bwd_dkv_kernel(*bw)
                bitwise = (torch.equal(o, o3) and torch.equal(lse, lse3)
                           and torch.equal(dq, dq3)
                           and torch.equal(dk, dk3) and torch.equal(dv, dv3))
                log(f"  flash {tag} {str(dt)[6:]} rerun: forward, dq and "
                    f"dk/dv bitwise {bitwise}")
                ok &= bitwise
                del o3, lse3, dq3, dk3, dv3
            # the library yardstick on (b, h, s, d) copies
            qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v, do))
            mask = None
            if bias is not None:
                mask = bias.to(dt)
            elif c["window"]:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] <= i[:, None]) & (
                    i[None, :] > i[:, None] - c["window"])
            lib_kw = dict(attn_mask=mask, dropout_p=c["rate"],
                          is_causal=c["causal"] and mask is None,
                          enable_gqa=hk != h)

            def lib_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

            def lib_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg, **lib_kw)
                return torch.autograd.grad(out, (qg, kg, vg), dot)
            kept = F.scaled_dot_product_attention(qg, kg, vg, **lib_kw)

            def lib_bwd():
                return torch.autograd.grad(kept, (qg, kg, vg), dot,
                                           retain_graph=True)

            isz = q.element_size()
            pairs = visible_pairs(s, s, c["causal"], c["window"])
            bias_bytes = 0 if bias is None else bias.numel() * 4
            q_b = b * s * h * d * isz            # q, o, dO or dq
            kv_b = b * s * hk * d * isz          # k, v, dk or dv
            row_b = b * h * s * 4                # lse or delta
            io_f = 2 * q_b + 2 * kv_b + row_b + bias_bytes
            io_dq = 3 * q_b + 2 * kv_b + 2 * row_b + bias_bytes
            io_dkv = 2 * q_b + 4 * kv_b + 2 * row_b + bias_bytes
            flops = 2 * b * h * pairs * d        # one product
            peak = FP32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
            shape = (b, s, h, hk, d)
            it = 20
            t_fb = queued_event_ms(torch, lib_fwd_bwd, it)
            lib_note = ("; library: SDPA backward alone, forward + backward "
                        "in library_fwd_bwd_ms")
            ok &= record(f"flash_fwd/{tag}", shape, dt, max(e_o, e_l),
                         p_o and p_l and p_dead,
                         lambda: A.flash_fwd_kernel(q, k, v, *args),
                         lambda: A.flash_fwd_reference(q, k, v, *args),
                         io_f, 2 * flops, lib_fwd, tol, ops_per_s=peak,
                         iters=it, lib_events=True,
                         extra=dict(route=route["fwd"]))
            ok &= record(f"flash_bwd_dq/{tag}", shape, dt, e_q, p_q,
                         lambda: A.flash_bwd_dq_kernel(*bw),
                         lambda: A.flash_bwd_dq_reference(*bw),
                         io_dq, 3 * flops, lib_bwd, tol + lib_note,
                         ops_per_s=peak, iters=it, lib_events=True,
                         extra=dict(library_fwd_bwd_ms=t_fb,
                                    route=route["dq"]))
            ok &= record(f"flash_bwd_dkv/{tag}", shape, dt, max(e_k, e_v),
                         p_k and p_v,
                         lambda: A.flash_bwd_dkv_kernel(*bw),
                         lambda: A.flash_bwd_dkv_reference(*bw),
                         io_dkv, 4 * flops, lib_bwd, tol + lib_note,
                         ops_per_s=peak, iters=it, lib_events=True,
                         extra=dict(library_fwd_bwd_ms=t_fb,
                                    route=route["dkv"]))
            log(f"  (SDPA forward + backward {t_fb:.5f} ms)")
            del o2, lse2, dq2, dk2, dv2, kept
            torch.cuda.empty_cache()
    return ok


def _flash_edge_checks(torch, g):
    """The flash kernels against their plain versions where the timed
    shapes do not reach: ragged tiles (sq, sk not multiples of 64), rows
    with no visible key (causal sq > sk, a bias masking a whole row),
    GQA with a window, dropout under a bias, fp16, and head_dim 72 (the
    FMA kernels for half inputs); the Hopper kernels' 128-wide tile
    edges (multiples of 64 but not of 128 with the causal sk - sq offset
    crossing a tile, a 257-row ragged tail under a key-padding bias, GQA
    8/2 at d = 128 with a window and dropout, a per-query bias with a
    dead row and dropout); head_dim 256 (causal GQA; a key-padding bias
    with dropout) and 70400 batch x heads (b 1100, h 64; MHA at d 64 and
    causal GQA with dropout at d 128); head_dim 80, where the forward,
    dq and dk/dv take the wgmma kernels' 16-column panels in half types
    (one query over 257 keys, 127 / 129 and 129 / 127, 257 under a
    key-padding bias with dropout, a per-query bias with a dead row and
    dropout, causal GQA 8/2 with a window, causal sq > sk whose first
    rows see no key, 70400 batch x heads); fp32, bf16 and fp16 each, the
    forward's and the backward's routes logged.  Correctness only, at
    small shapes."""
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    # (b, sq, sk, h, hk, d, causal, window, bias shape, dropout rate)
    cases = [(2, 100, 130, 4, 4, 64, False, None, None, 0.0),
             # head dim 256 (the FMA kernels' 32-row tiles), and more
             # than 65535 batch x heads on short sequences
             (2, 130, 200, 4, 2, 256, True, None, None, 0.0),
             (2, 96, 160, 4, 4, 256, False, None, (2, 1, 1, 160), 0.1),
             (1100, 3, 5, 64, 64, 64, False, None, None, 0.0),
             (1100, 3, 5, 64, 16, 128, True, None, None, 0.1),
             (2, 96, 64, 2, 2, 64, True, None, None, 0.0),
             (2, 200, 200, 4, 1, 128, True, 50, None, 0.0),
             (2, 128, 128, 4, 4, 64, False, None, (2, 1, 1, 128), 0.1),
             (2, 72, 136, 4, 4, 72, False, None, (1, 4, 72, 136), 0.0),
             (2, 192, 320, 4, 4, 64, True, None, None, 0.0),
             (2, 257, 257, 4, 4, 64, False, None, (2, 1, 1, 257), 0.0),
             (2, 257, 257, 2, 2, 128, False, None, (2, 1, 1, 257), 0.0),
             (2, 200, 200, 8, 2, 128, True, 50, None, 0.1),
             (2, 130, 200, 4, 4, 64, False, None, (2, 4, 130, 200), 0.1),
             # head dim 80: the wgmma kernels' edges
             (2, 1, 257, 4, 4, 80, False, None, None, 0.0),
             (2, 127, 129, 4, 4, 80, True, None, None, 0.0),
             (2, 129, 127, 4, 4, 80, False, None, (2, 4, 129, 127), 0.1),
             (2, 257, 257, 4, 4, 80, False, None, (2, 1, 1, 257), 0.1),
             (2, 200, 200, 8, 2, 80, True, 50, None, 0.0),
             (2, 200, 120, 4, 4, 80, True, None, None, 0.0),
             (1100, 3, 5, 64, 64, 80, False, None, None, 0.0)]
    ok = True
    for b, sq, sk, h, hk, d, causal, window, bs, rate in cases:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            q, do = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dt)
                     for _ in range(2))
            k, v = (torch.randn(b, sk, hk, d, generator=g, device=dev).to(dt)
                    for _ in range(2))
            bias = None
            if bs is not None:
                bias = torch.where(
                    torch.rand(bs, generator=g, device=dev) < 0.2,
                    torch.tensor(-1e30, device=dev),
                    0.5 * torch.randn(bs, generator=g, device=dev))
                if bs[2] > 1:
                    bias[..., 3, :] = -1e30          # a row sees no key
            args = (bias, d ** -0.5, causal, window, rate, 1234)
            o, lse = A.flash_fwd_kernel(q, k, v, *args)
            o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
            delta = A.attention_delta(do, o2)
            bw = (q, k, v, bias, do, lse2, delta) + args[1:]
            got = (o, A.flash_bwd_dq_kernel(*bw), *A.flash_bwd_dkv_kernel(*bw))
            ref = (o2, A.flash_bwd_dq_reference(*bw),
                   *A.flash_bwd_dkv_reference(*bw))
            torch.cuda.synchronize()
            rel = 1e-5 if dt == torch.float32 else 2 ** -7
            live = lse2 > -1e29
            errs = [_close_rel(torch, a, r, rel) for a, r in zip(got, ref)]
            errs.append(_close_rel(torch, lse[live], lse2[live], 1e-5))
            passed = (all(p for _, p in errs)
                      and bool((lse[~live] < -1e29).all())
                      and all(bool(torch.isfinite(t).all()) for t in got))
            log(f"  flash edge {(b, sq, sk, h, hk, d)} causal={causal} "
                f"window={window} bias={bs} rate={rate} {str(dt)[6:]} "
                f"(forward {A.flash_route('fwd', dt, d)}, "
                f"backward {A.flash_route('dq', dt, d)}): "
                f"max err {max(e for e, _ in errs):.3g}, "
                f"dead rows {int((~live).sum())} "
                f"{'ok' if passed else 'FAIL'}")
            ok &= passed
    return ok


def _sampling_ops(vocab, cfg):
    """``(fp32, int32)`` operations that any implementation of sampling
    must do on one row with ``cfg`` — not this kernel's own passes.

    A greedy row compares each element once.  A sampled row, per
    element: the temperature scale, the noise (threefry-2x32: 2 key
    adds, 20 rounds of add/rotate/xor, 5 key injections of 2 adds, then
    xor/shift/or of the lanes = 75 int32 operations; the float from the
    bits, the floor, two logs and two negations = 8 fp32), the add to
    the logit and the argmax compare; one compare more for top-k, and an
    exp, an add (the mass Z) and a compare for top-p."""
    temp, top_k, top_p = cfg
    if temp <= 0:
        return vocab, 0
    fp = 1 + 8 + 2
    if 0 < top_k < vocab:
        fp += 1
    if 0 < top_p < 1:
        fp += 3
    return vocab * fp, vocab * 75


def _sampling_edge_checks(torch, g):
    """B-11 at the edges of its envelope, against the plain version
    (nucleus ties excepted) and bitwise on a rerun: vocabularies 999,
    1001 and 32001 with top_k 1, 2, vocab - 1 and vocab and top_p 1e-4
    and 0.9999; top_k above the vocabulary equal to top_k = vocab (no
    filter; the plain version's gather takes no such index); integer
    logits with many ties at the k-th place, an all-equal row,
    bf16-rounded logits; a vocabulary of 1 and of 7; 200 and 150 rows of
    32000 (one and two CTAs a row, several waves); and rows too wide
    for a cluster's shared memory (1 x 10^6 fp32, 2 x 1000003 bf16), whose
    keys go through a scratch buffer."""
    from apex_tpu_torch.ops import fused_sampling as fs

    dev = torch.device("cuda")
    ok = True

    def check(tag, logits, cfgs):
        rows, vocab = logits.shape
        t = torch.tensor([c[0] for c in cfgs], device=dev)
        k = torch.tensor([c[1] for c in cfgs], dtype=torch.int32, device=dev)
        p = torch.tensor([c[2] for c in cfgs], device=dev)
        keys = fs.split(torch.stack([fs.prng_key(1000 + i, dev)
                                     for i in range(rows)]))[:, 0]
        y = fs.fused_sample(logits, keys, t, k, p)
        y2 = fs.fused_sample(logits, keys, t, k, p)
        kv = torch.where(k > vocab, torch.zeros_like(k), k)
        r = fs.fused_sample_reference(logits, keys, t, kv, p, vocab)
        torch.cuda.synchronize()
        mism = (y != r).nonzero().flatten().tolist()
        ties = [i for i in mism if _nucleus_tie(
            torch, logits[i], cfgs[i], int(y[i]), int(r[i]))]
        good = len(mism) == len(ties) and torch.equal(y, y2)
        plan = fs.sample_plan(rows, vocab, logits.element_size(),
                              fs._capacity(dev, logits.dtype))
        log(f"  sampling edge {tag} {rows}x{vocab} {str(logits.dtype)[6:]} "
            f"{plan}: mismatches {mism}, nucleus ties {ties}, rerun "
            f"{torch.equal(y, y2)} {'ok' if good else 'FAIL'}")
        return good

    for v in (999, 1001, 32001):
        logits = 2.0 * torch.randn(8, v, generator=g, device=dev)
        ok &= check(f"k/p", logits, [
            (1.0, 1, 0.0), (1.0, 2, 0.3), (1.0, v - 1, 0.0),
            (1.0, v, 0.9999), (0.9, 0, 1e-4), (1.0, v + 5, 0.0),
            (0.0, 3, 0.5), (1.3, 7, 1.0)])
    lg = torch.randint(0, 6, (6, 5000), generator=g, device=dev).float()
    lg[1] = 0.5
    lg[2] = (2 * torch.randn(5000, generator=g, device=dev)).to(
        torch.bfloat16).float()
    ok &= check("ties", lg, [(1.0, 40, 0.0), (1.0, 7, 0.5), (0.9, 100, 0.9),
                             (1.0, 4999, 0.0), (1.0, 1, 0.0), (1.0, 0, 0.7)])
    ok &= check("vocab1", torch.randn(3, 1, generator=g, device=dev),
                [(1.0, 0, 0.5), (0.0, 0, 0.0), (1.0, 1, 0.0)])
    ok &= check("vocab7", torch.randn(5, 7, generator=g, device=dev).half(),
                [(1.0, 2, 0.5)] * 5)
    # many rows: one CTA a row (bf16), two (fp32), several waves
    ok &= check("rows", 2.0 * torch.randn(200, 32000, generator=g,
                                          device=dev).bfloat16(),
                [(0.0, 0, 0.0), (0.8, 40, 0.0), (1.0, 0, 0.9),
                 (0.7, 50, 0.8)] * 50)
    ok &= check("rows", 2.0 * torch.randn(150, 32000, generator=g,
                                          device=dev),
                [(1.0, 0, 0.0), (0.9, 20, 0.95), (0.0, 0, 0.0)] * 50)
    ok &= check("streamed", 2.0 * torch.randn(1, 10 ** 6, generator=g,
                                              device=dev), [(0.9, 50, 0.9)])
    ok &= check("streamed", (2.0 * torch.randn(
        2, 1000003, generator=g, device=dev)).bfloat16(),
        [(1.0, 0, 0.0), (0.8, 0, 0.8)])
    return ok


def _nucleus_tie(torch, row, cfg, tok_a, tok_b):
    """Whether two differing tokens are explained by the documented
    nucleus-boundary rounding: top-p on, and the exclusive cumulative
    mass (fp64, sorted) at the boundary within 1e-5 of top_p."""
    temp, top_k, top_p = cfg
    if not 0 < top_p < 1:
        return False
    x = row.double() / max(temp, 1e-6)
    desc = torch.sort(x, descending=True).values
    if 0 < top_k < x.numel():
        desc = desc[:top_k]
    pr = torch.softmax(desc, 0)
    excl = torch.cumsum(pr, 0) - pr
    return bool((excl - top_p).abs().min() <= 1e-5)


# ------------------------------------------------------------------ #
# phase 2: engine identity at full width, depth 2
# ------------------------------------------------------------------ #
def phase_identity(torch):
    from apex_tpu_torch.models import LlamaConfig, LlamaModel, generate
    from apex_tpu_torch.serving import InferenceServer

    log("phase 2: engine identity (llama2_7b width, 2 layers, fp32)")
    dev = torch.device("cuda")
    model = LlamaModel(LlamaConfig.llama2_7b(num_layers=2), device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    lens = (9, 30, 77, 120)
    prompts = [torch.randint(0, VOCAB, (n,), generator=gen).numpy()
               for n in lens]
    sampled = [dict(temperature=0.8, top_k=40, top_p=None, seed=11),
               dict(temperature=1.0, top_k=None, top_p=0.9, seed=12),
               dict(temperature=0.7, top_k=20, top_p=0.8, seed=13),
               dict(temperature=1.1, top_k=None, top_p=None, seed=14)]

    def serve():
        with InferenceServer(model, max_slots=4,
                             prompt_buckets=(32, 128)) as srv:
            hs = [srv.submit(p, max_new_tokens=16) for p in prompts]
            hs += [srv.submit(p, max_new_tokens=16, **s)
                   for p, s in zip(prompts, sampled)]
            return [h.result(timeout=600) for h in hs]

    first = serve()
    again = serve()
    ok = True
    for p, got in zip(prompts, first[:4]):
        ref = generate(model, torch.from_numpy(p)[None],
                       max_new_tokens=16)[0, len(p):].tolist()
        same = ref == got
        ok &= same
        log(f"  greedy len {len(p)}: server == generate(): {same}")
    same = first[4:] == again[4:]
    ok &= same
    log(f"  sampled requests equal on rerun: {same}")
    ok &= _paged_identity(torch, model, prompts, sampled, first[4:])
    del model
    torch.cuda.empty_cache()
    return ok


def _paged_identity(torch, model, prompts, sampled, dense_sampled):
    """The paged server on the same model: greedy equals generate() at
    prompt lengths straddling pages of 16 and chunks of 32; the sampled
    requests equal the dense server's; with speculation (3 drafts),
    with a shared 48-token prefix, and with a 256-token pool that forces
    preemption, greedy still equals generate() and every page comes
    back."""
    from apex_tpu_torch.models import generate
    from apex_tpu_torch.serving import InferenceServer

    gen = torch.Generator().manual_seed(5)

    def rand(n):
        return torch.randint(0, VOCAB, (n,), generator=gen).numpy()

    def serve(reqs, lead=0, **kw):
        with InferenceServer(model, kv_cache="paged", max_slots=4,
                             block_size=16, prefill_chunk=32, **kw) as srv:
            out, _wall, _launches, shared = _serve_run(
                torch, srv, reqs, lead=lead,
                poll=lambda: srv.engine.shared_blocks)
            health = srv.health()
            health["peak_shared_blocks"] = shared
            preempts = srv.scheduler.preempts
        return out, health, preempts

    def greedy_ok(tag, ps, out, n):
        good = True
        for p, got in zip(ps, out):
            ref = generate(model, torch.from_numpy(p)[None],
                           max_new_tokens=n)[0, len(p):].tolist()
            good &= ref == got
        log(f"  paged {tag}: greedy == generate() for lengths "
            f"{[len(p) for p in ps]}: {good}")
        return good

    ok = True
    straddle = [rand(n) for n in (15, 16, 17, 31, 32, 33, 47, 64)]
    reqs = [(p, dict(max_new_tokens=12)) for p in straddle]
    reqs += [(p, dict(max_new_tokens=16, **k))
             for p, k in zip(prompts, sampled)]
    out, health, _ = serve(reqs)
    ok &= greedy_ok("boundaries", straddle, out[:8], 12)
    same = out[8:] == dense_sampled
    ok &= same and health["blocks_in_use"] == 0
    log(f"  paged sampled requests == dense server's: {same}")
    # lookup-friendly prompts: a repeated 6-token phrase
    rep = [np.tile(rand(6), 5), np.concatenate([rand(9), np.tile(rand(4),
                                                                 6)])]
    out, health, _ = serve([(p, dict(max_new_tokens=16)) for p in rep],
                           spec_tokens=3)
    ok &= greedy_ok(f"spec (accept {health['spec_accept_rate']:.3f})",
                    rep, out, 16) and health["blocks_in_use"] == 0
    pref = rand(48)
    shared = [np.concatenate([pref, rand(n)]) for n in (5, 11, 0, 20)]
    out, health, _ = serve([(p, dict(max_new_tokens=10)) for p in shared],
                           lead=1, share_prefixes=True)
    ok &= greedy_ok(f"shared prefix (peak shared pages "
                    f"{health['peak_shared_blocks']}, cow_forks "
                    f"{health['cow_forks']})", shared, out, 10)
    ok &= (health["blocks_in_use"] == 0 and health["cow_forks"] > 0
           and health["peak_shared_blocks"] > 0)
    long = [rand(n) for n in (60, 70, 80, 90)]
    out, health, preempts = serve(
        [(p, dict(max_new_tokens=40)) for p in long], pool_tokens=256,
        admit_headroom=0)
    ok &= greedy_ok(f"pool of 256 tokens ({preempts} preemptions)", long,
                    out, 40)
    ok &= preempts > 0 and health["blocks_in_use"] == 0
    log(f"  paged blocks_in_use at the end: {health['blocks_in_use']}")
    return ok


# ------------------------------------------------------------------ #
# phase 3: the slice — Llama-2-7B bf16 served end to end
# ------------------------------------------------------------------ #
def llama2_7b(torch):
    """Llama-2-7B at its published widths and depth, bf16, with random
    weights from a seeded generator — built once, served by phases 3, 6
    and 7."""
    from apex_tpu_torch.models import LlamaConfig, LlamaModel

    dev = torch.device("cuda")
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = LlamaModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    log(f"  Llama-2-7B weights: {sum(p.numel() for p in model.parameters())}"
        f" params in {time.monotonic() - t0:.1f}s")
    return model


def serve_prompts(torch):
    """Phase 3's eight prompts (20-500 tokens); the last four are the
    ~500-token contexts of steady decode in phases 3 and 6."""
    gen = torch.Generator().manual_seed(4)
    lens = (20, 57, 130, 250, 333, 410, 480, 500)
    return [torch.randint(0, VOCAB, (n,), generator=gen).numpy()
            for n in lens]


def _steady_decode(eng, prompts, n_windows=3, window=16):
    """Admit ``prompts`` into the engine's slots, run them past their
    prefill, then time ``n_windows`` windows of ``window`` steps; a step
    emits one token per slot, or up to ``1 + spec_tokens`` with drafts
    (the budgets leave room for every step to emit its most).  Returns
    ``(step_ms, window_ms, tokens)``, ``tokens`` emitted by the timed
    steps."""
    per_step = 1 + getattr(eng, "spec_tokens", 0)
    for slot, p in enumerate(prompts):
        eng.admit(slot, p, max_new_tokens=n_windows * window * per_step + 64)
    busy = getattr(eng, "_tenants", None)
    while busy and any(t is not None and t.fed < t.prompt.size
                       for t in busy):
        eng.step()
    eng.step()
    step_ms, windows, tokens = [], [], 0
    for _ in range(n_windows):
        t_w = time.monotonic()
        for _ in range(window):
            t0 = time.monotonic()
            out = eng.step()
            step_ms.append((time.monotonic() - t0) * 1e3)
            # the dense engine's (tokens, finished) pair: one per slot
            counts = getattr(out, "counts", None)
            tokens += len(prompts) if counts is None else int(counts.sum())
        windows.append((time.monotonic() - t_w) / window * 1e3)
    return step_ms, windows, tokens


def _rope_step_check(torch, eng, steps=2):
    """RoPE over ``steps`` engine steps: its kernel launches a step, the
    ``_rope_qk`` calls a step, and whether every call got q and k as
    views of one storage — the packed qkv projection — with contiguous
    channels, so that neither was copied between ``qkv_proj`` and the
    kernel."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import transformer as T

    seen, orig = [], T._rope_qk

    def spy(q, k, cos, sin, **kw):
        seen.append(q.untyped_storage().data_ptr()
                    == k.untyped_storage().data_ptr()
                    and q.stride(-1) == 1 and k.stride(-1) == 1)
        return orig(q, k, cos, sin, **kw)
    torch.cuda.synchronize()
    _build.reset_launches()
    T._rope_qk = spy
    try:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    finally:
        T._rope_qk = orig
    return dict(rope_launches_per_step=_build.launches["rope"] / steps,
                rope_qk_calls_per_step=len(seen) / steps,
                qk_views_of_projection=bool(seen) and all(seen))


def _rope_step_ok(rope, layers):
    """One RoPE launch a layer, every call on views of the projection."""
    good = (rope["rope_launches_per_step"] == layers
            and rope["qk_views_of_projection"])
    log(f"  rope: {rope['rope_launches_per_step']:g} launches a step "
        f"({layers} layers), q and k read from the projection: "
        f"{rope['qk_views_of_projection']} {'ok' if good else 'FAIL'}")
    return good


def phase_serve(torch, model, profile=False):
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import init_cache, prefill_tokens
    from apex_tpu_torch.serving import InferenceServer

    log("phase 3: Llama-2-7B bf16, InferenceServer, 8 requests")
    dev = torch.device("cuda")
    prompts = serve_prompts(torch)
    params = [dict(), dict(temperature=0.8, top_k=50, seed=1), dict(),
              dict(temperature=1.0, top_p=0.9, seed=2), dict(),
              dict(temperature=0.7, top_k=40, top_p=0.95, seed=3), dict(),
              dict(temperature=1.2, seed=4)]
    torch.cuda.reset_peak_memory_stats()
    srv = InferenceServer(model, max_slots=4, prompt_buckets=(32, 128, 512))
    t0 = time.monotonic()
    srv.start()
    warm_s = time.monotonic() - t0
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.monotonic()
    hs = [srv.submit(p, max_new_tokens=32, **kw)
          for p, kw in zip(prompts, params)]
    results = [h.result(timeout=900) for h in hs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(_build.launches)
    steps = srv.steps
    lat = srv.latency_summary()
    srv.shutdown()
    ok = srv.error is None
    ntok = sum(len(r) for r in results)
    ok &= all(len(r) == 32 for r in results)
    ok &= all(0 <= t < VOCAB for r in results for t in r)
    # logits of one prompt through the same prefill path: finite
    one = init_cache(model, 1)
    last, _ = prefill_tokens(model, one, torch.from_numpy(
        prompts[0][None]).to(dev))
    finite = bool(torch.isfinite(last).all())
    ok &= finite
    peak = torch.cuda.max_memory_allocated()
    # steady decode: all four slots live near the 512-token bucket, one
    # engine step (batched forward + fused sampling + the host sync) is
    # one token per slot; every step of three 16-step windows is timed
    eng = srv.engine
    step_ms, windows, dec_tok = _steady_decode(
        eng, [prompts[-1 - slot] for slot in range(eng.max_slots)])
    decode_s = sum(step_ms) / 1e3
    rope = _rope_step_check(torch, eng)
    prof = _profile_steps(torch, eng, groups=DECODE_GROUPS) if profile \
        else None
    for slot in range(eng.max_slots):
        eng.release(slot)
    stats = dict(requests=len(results), tokens=ntok, steps=steps,
                 wall_s=wall, warmup_s=warm_s,
                 serve_tokens_per_s=ntok / wall, launches=launches,
                 decode_steps=len(step_ms), decode_s=decode_s,
                 decode_tokens_per_s=dec_tok / decode_s,
                 decode_step_ms_windows=windows,
                 decode_step_ms_min=min(step_ms),
                 decode_step_ms_max=max(step_ms),
                 peak_bytes=peak, logits_finite=finite,
                 decode_rope=rope, **lat)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok &= all(launches[n] > 0 for n in SERVING_KERNELS)
    ok &= _rope_step_ok(rope, model.cfg.num_layers)
    del one, eng, srv
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phases 6 and 7: the paged slice — Llama-2-7B bf16 on the paged pool
# ------------------------------------------------------------------ #
def _serve_run(torch, srv, reqs, poll=None, lead=0):
    """Submit ``reqs`` to a started server and wait; returns the results,
    the wall seconds, the launches and the largest ``poll()`` seen.  The
    first ``lead`` requests go first, and the rest only once those have
    streamed a token (their prompt pages are then in the prefix trie)."""
    from apex_tpu_torch import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.monotonic()
    hs = [srv.submit(p, **kw) for p, kw in reqs[:lead]]
    for h in hs:
        next(h.stream(timeout=600))
    hs += [srv.submit(p, **kw) for p, kw in reqs[lead:]]
    peak = 0
    while not all(h.done for h in hs):
        if poll is not None:
            peak = max(peak, poll())
        time.sleep(0.01)
    results = [h.result(timeout=900) for h in hs]
    torch.cuda.synchronize()
    return results, time.monotonic() - t0, dict(_build.launches), peak


def phase_paged(torch, model, profile=False):
    """Phase 6: Llama-2-7B bf16 served from a paged pool of 16384
    tokens — the bytes of phase 3's 4 × 4096 slab — at 8 slots, chunk
    128: 16 requests of 20-1000 prompt and 64 new tokens, half greedy,
    half sampled; then steady decode at 4 slots of ~500 tokens (phase
    3's contexts) and at 8 slots."""
    from apex_tpu_torch.serving import InferenceServer

    log("phase 6: Llama-2-7B bf16, InferenceServer(kv_cache='paged'), "
        "16 requests")
    gen = torch.Generator().manual_seed(6)
    lens = torch.randint(20, 1001, (16,), generator=gen).tolist()
    prompts = [torch.randint(0, VOCAB, (n,), generator=gen).numpy()
               for n in lens]
    reqs = [(p, dict(max_new_tokens=64) if i % 2 == 0 else dict(
        max_new_tokens=64, temperature=0.8, top_k=50, top_p=0.95, seed=i))
        for i, p in enumerate(prompts)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = InferenceServer(model, kv_cache="paged", max_slots=8,
                          block_size=16, prefill_chunk=128, pool_tokens=16384)
    t0 = time.monotonic()
    srv.start()
    warm_s = time.monotonic() - t0
    results, wall, launches, peak_blocks = _serve_run(
        torch, srv, reqs, poll=lambda: srv.engine.blocks_in_use)
    steps = srv.steps
    lat = srv.latency_summary()
    srv.shutdown()
    eng = srv.engine
    ntok = sum(len(r) for r in results)
    ok = (srv.error is None and all(len(r) == 64 for r in results)
          and all(0 <= t < VOCAB for r in results for t in r)
          and eng.blocks_in_use == 0)
    peak = torch.cuda.max_memory_allocated()
    four = serve_prompts(torch)[-4:][::-1]
    s4, w4, t4 = _steady_decode(eng, four)
    prof = {}
    if profile:
        prof["slots_4"] = _profile_steps(torch, eng, groups=DECODE_GROUPS)
    for slot in range(4):
        eng.release(slot)
    s8, w8, t8 = _steady_decode(eng, serve_prompts(torch))
    if profile:
        prof["slots_8"] = _profile_steps(torch, eng, groups=DECODE_GROUPS)
    for slot in range(8):
        eng.release(slot)
    # chunked prefill: 8 prompts of 1000 tokens, every slot prefilling in
    # every step: RoPE's launches and inputs over the 1st-2nd chunks of
    # 128, then (under --profile) the device time over the 4th-7th
    long = [torch.randint(0, VOCAB, (1000,), generator=gen).numpy()
            for _ in range(8)]
    for slot, p in enumerate(long):
        eng.admit(slot, p, max_new_tokens=1)
    rope = _rope_step_check(torch, eng)
    if profile:
        prof["prefill_8"] = _profile_steps(torch, eng, groups=PREFILL_GROUPS)
    for slot in range(8):
        eng.release(slot)
    ok &= eng.blocks_in_use == 0
    stats = dict(requests=len(results), prompt_lens=lens, tokens=ntok,
                 steps=steps, wall_s=wall, warmup_s=warm_s,
                 serve_tokens_per_s=ntok / wall, launches=launches,
                 peak_bytes=peak, peak_blocks_in_use=peak_blocks,
                 blocks_total=eng.blocks_total, pool_tokens=eng.pool_tokens,
                 blocks_in_use_end=eng.blocks_in_use,
                 decode4_tokens_per_s=t4 / (sum(s4) / 1e3),
                 decode4_step_ms_windows=w4, decode4_step_ms_min=min(s4),
                 decode4_step_ms_max=max(s4),
                 decode8_tokens_per_s=t8 / (sum(s8) / 1e3),
                 decode8_step_ms_windows=w8, decode8_step_ms_min=min(s8),
                 decode8_step_ms_max=max(s8), chunk_rope=rope, **lat)
    log(f"  {json.dumps(stats)}")
    if prof:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok &= all(launches[n] > 0 for n in PAGED_KERNELS)
    ok &= _rope_step_ok(rope, model.cfg.num_layers)
    del eng, srv
    torch.cuda.empty_cache()
    return ok, stats


def phase_paged_int8(torch, model, profile=False):
    """Phase 7: the same model on an int8 pool with prefix sharing and
    speculation (3 drafts): 8 requests, 4 behind one 256-token system
    prompt, every prompt repeating phrases so lookup drafts hit; run
    twice, greedy results must repeat.  Then steady decode at phase 6's
    four ~500-token contexts, counting the tokens the drafts add."""
    from apex_tpu_torch.serving import InferenceServer

    log("phase 7: Llama-2-7B bf16, int8 pages, shared prefixes, "
        "spec_tokens=3, 8 requests")
    gen = torch.Generator().manual_seed(7)

    def rand(n):
        return torch.randint(0, VOCAB, (n,), generator=gen).numpy()

    system = np.tile(rand(32), 8)                       # 256 tokens
    # request 0 goes first; 1 is the bare system prompt (a whole-prompt
    # hit: its last page is forked), 2 and 3 share it, 4-7 do not
    prompts = [system if i == 1 else np.concatenate(
        [system, np.tile(rand(12), 4 + i)]) if i < 4
        else np.tile(rand(12), 4 + i) for i in range(8)]
    reqs = [(p, dict(max_new_tokens=48) if i % 2 == 0 else dict(
        max_new_tokens=48, temperature=0.7, top_k=40, seed=100 + i))
        for i, p in enumerate(prompts)]
    runs, eng = [], None
    for _ in range(2):
        eng = None
        torch.cuda.empty_cache()
        srv = InferenceServer(model, kv_cache="paged", max_slots=8,
                              block_size=16, prefill_chunk=128,
                              kv_dtype="int8", share_prefixes=True,
                              spec_tokens=3)
        srv.start()
        results, wall, launches, peak_shared = _serve_run(
            torch, srv, reqs, poll=lambda: srv.engine.shared_blocks, lead=1)
        health = srv.health()
        srv.shutdown()
        runs.append((results, wall, launches, peak_shared, health,
                     srv.error))
        eng = srv.engine
        del srv
    (results, wall, launches, peak_shared, health, err), rerun = runs[0], \
        runs[1]
    # steady decode on the rerun's engine at phase 6's four ~500-token
    # contexts (drafts on: a step emits 1-4 tokens per slot)
    proposed, accepted = eng.spec_proposed, eng.spec_accepted
    s4, w4, t4 = _steady_decode(eng, serve_prompts(torch)[-4:][::-1])
    prof = (_profile_steps(torch, eng, groups=DECODE_GROUPS) if profile
            else None)
    for slot in range(4):
        eng.release(slot)
    proposed = eng.spec_proposed - proposed
    accept4 = (eng.spec_accepted - accepted) / proposed if proposed else 0.0
    ntok = sum(len(r) for r in results)
    greedy_same = [results[i] == rerun[0][i] for i in range(0, 8, 2)]
    stats = dict(requests=len(results), tokens=ntok, wall_s=wall,
                 serve_tokens_per_s=ntok / wall, launches=launches,
                 peak_shared_blocks=peak_shared,
                 cow_forks=health["cow_forks"],
                 spec_accept_rate=health["spec_accept_rate"],
                 kv_dtype=health["kv_dtype"], kv_bits=health["kv_bits"],
                 blocks_total=health["blocks_total"],
                 blocks_in_use_end=health["blocks_in_use"],
                 greedy_equal_on_rerun=greedy_same,
                 decode4_tokens_per_s=t4 / (sum(s4) / 1e3),
                 decode4_tokens_per_slot_step=t4 / (4 * len(s4)),
                 decode4_step_ms_windows=w4,
                 decode4_spec_accept_rate=accept4)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok = (err is None and rerun[5] is None and all(greedy_same)
          and eng.blocks_in_use == 0
          and all(len(r) == 48 for r in results)
          and all(0 <= t < VOCAB for r in results for t in r)
          and health["blocks_in_use"] == 0
          and rerun[4]["blocks_in_use"] == 0 and peak_shared > 0
          and health["cow_forks"] > 0
          and all(launches[n] > 0 for n in PAGED_KERNELS))
    return ok, stats


# ------------------------------------------------------------------ #
# phase 4: BERT-Large amp O2 training
# ------------------------------------------------------------------ #
def _bert_batch(torch, cfg, b, s, p, seed, dev):
    """Seeded ids, ``p`` distinct masked positions per row (sorted as
    drawn) and their labels — bench.py's batch."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    pos = torch.argsort(torch.rand(b, s, generator=g, device=dev),
                        dim=-1)[:, :p]
    return ids, pos, torch.gather(ids, 1, pos)


def _event_times(torch, fn, n):
    """Run ``fn`` ``n`` times back to back with a CUDA event pair around
    each, synchronise once after, and return the per-run device ms, the
    outputs and the per-run host ms of the calls (the enqueue: when it
    matches the device ms, the host sets the pace)."""
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    outs, host_ms = [], []
    for a, z in evs:
        t0 = time.perf_counter()
        a.record()
        outs.append(fn())
        z.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return [a.elapsed_time(z) for a, z in evs], outs, host_ms


def phase_train(torch, profile=False, steps=10, warmup=3):
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn
    from apex_tpu_torch.optim import fused_adam

    log("phase 4: BERT-Large amp O2 training, b=16 s=512 P=80")
    dev = torch.device("cuda")
    b, s, p = 16, 512, 80
    cfg = BertConfig.bert_large(dtype=torch.bfloat16, remat=True)
    model = BertModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(5))
    state = amp.initialize(model, fused_adam(1e-4), "O2",
                           half_dtype=torch.bfloat16)
    ids, pos, labels = _bert_batch(torch, cfg, b, s, p, 6, dev)

    def loss_of():
        logits, _ = model(ids, mlm_positions=pos)
        return bert_mlm_loss_fn(logits.float(), labels)

    def train_step():
        loss = loss_of()
        state.scale_loss(loss).backward()
        finite = state.apply_gradients()
        return loss.detach(), finite

    def fwd_only():
        with torch.no_grad():
            return loss_of()

    def fwd_bwd():
        loss = loss_of()
        state.scale_loss(loss).backward()
        for q in model.parameters():
            q.grad = None
        return loss.detach()

    for _ in range(warmup):
        train_step()
    torch.cuda.synchronize()
    # bench.py's split: forward alone, forward+backward, the full step
    t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
    t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, outs, host_ms = _event_times(torch, train_step, steps)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o[0]) for o in outs]
    finite = [bool(o[1]) for o in outs]
    t_o2 = sum(step_ms) / len(step_ms)
    prof = _profile_train(torch, train_step, groups=BERT_GROUPS) \
        if profile else None
    per_step = {k: v / steps for k, v in launches.items()}
    del model, state, outs
    torch.cuda.empty_cache()
    t_o0, o0_ms = _o0_baseline(torch, cfg, b, s, p)
    stats = dict(
        samples_per_s=b * steps / (sum(step_ms) / 1e3),
        step_ms=step_ms, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        host_ms_per_step=sum(host_ms) / len(host_ms),
        fwd_ms=t_fwd, bwd_ms=max(t_fb - t_fwd, 0.0),
        opt_ms=max(t_o2 - t_fb, 0.0), peak_bytes=peak,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        finite=finite, launches_per_step=per_step, launches=launches,
        o0_step_ms=o0_ms, o0_samples_per_s=b / (t_o0 / 1e3),
        vs_baseline=t_o0 / t_o2)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok = all(finite) and losses[-1] < losses[0]
    for name, want in TRAIN_LAUNCHES.items():
        if per_step[name] != want:
            log(f"  launches of {name}: {per_step[name]} per step, "
                f"expected {want}")
            ok = False
    return ok, stats


def _o0_baseline(torch, cfg, b, s, p, steps=5, warmup=2):
    """bench.py's baseline: the same model in fp32 (the same ops), a
    plain per-tensor Adam; mean step ms and the step times."""
    import dataclasses

    from apex_tpu_torch.models import BertModel, bert_mlm_loss_fn

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = BertModel(cfg32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(5))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, foreach=False)
    ids, pos, labels = _bert_batch(torch, cfg32, b, s, p, 6, dev)

    def step():
        logits, _ = model(ids, mlm_positions=pos)
        loss = bert_mlm_loss_fn(logits.float(), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    for _ in range(warmup):
        step()
    ms = _event_times(torch, step, steps)[0]
    del model, opt
    torch.cuda.empty_cache()
    return sum(ms) / len(ms), ms


def _profile_train(torch, train_step, n=2, groups=None):
    """Device time by kernel over ``n`` training steps, and the share of
    the window the device was idle (torch.profiler, CUPTI); ``groups``
    (name -> regex on the kernel name) adds the device ms per step of
    each group, the rest under "other"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        t0 = time.monotonic()
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = [(_device_us(e), e.key, e.count) for e in pr.key_averages()
            if _is_kernel(e) and _device_us(e) > 0]
    return _profile_summary(rows, n, wall_us, groups)


# ------------------------------------------------------------------ #
# phase 5: training identity, card against CPU
# ------------------------------------------------------------------ #
def phase_train_identity(torch):
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn

    log("phase 5: training identity (BERT-Large width, 2 layers, fp32, "
        "padded keys, attention dropout 0.1)")
    dev = torch.device("cuda")
    cfg = BertConfig.bert_large(num_layers=2, attention_dropout=0.1)
    gpu = BertModel(cfg, device=dev)
    gpu.init_weights(torch.Generator(device=dev).manual_seed(7))
    cpu = BertModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    b, s, p = 2, 512, 80
    ids, pos, labels = _bert_batch(torch, cfg, b, s, p, 8, dev)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0, 400:] = 0
    mask[1, 300:] = 0
    out = {}
    for name, model, d in (("cuda", gpu, dev), ("cpu", cpu, "cpu")):
        logits, pooled = model(ids.to(d), attention_mask=mask.to(d),
                               mlm_positions=pos.to(d), deterministic=False,
                               dropout_seed=99)
        loss = bert_mlm_loss_fn(logits.float(), labels.to(d))
        loss.backward()
        out[name] = (loss.detach().cpu(), logits.detach().cpu(),
                     {n: q.grad.detach().cpu()
                      for n, q in model.named_parameters()
                      if q.grad is not None})
    (l_g, lg_g, gr_g), (l_c, lg_c, gr_c) = out["cuda"], out["cpu"]
    rel = 1e-4          # fp32 sums in another order, through 2 layers
    loss_err = float((l_g - l_c).abs() / l_c.abs())
    logit_err = float((lg_g - lg_c).abs().max() / lg_c.abs().max())
    grad_err = {n: float((gr_g[n] - g).abs().max()
                         / max(float(g.abs().max()), 1e-30))
                for n, g in gr_c.items()}
    worst = max(grad_err.items(), key=lambda kv: kv[1])
    ok = (set(gr_g) == set(gr_c) and loss_err <= rel and logit_err <= rel
          and worst[1] <= rel)
    stats = dict(loss_cuda=float(l_g), loss_cpu=float(l_c),
                 loss_rel_err=loss_err, logits_rel_err=logit_err,
                 grads=len(grad_err), worst_grad=worst[0],
                 worst_grad_rel_err=worst[1], tolerance=rel)
    log(f"  {json.dumps(stats)}")
    del gpu, cpu, out
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 10: BERT-Large amp O2 training with fp8 Adam moments
# ------------------------------------------------------------------ #
def phase_train_fp8(torch, profile=False, steps=10, warmup=3,
                    dense_peak=None):
    """``bench.py``'s ``BENCH_MOMENT_DTYPE=fp8`` step: phase 4's model
    and batch with ``fused_adam(1e-4, moment_format="fp8_block_scaled")``
    (no O0 baseline: phase 4 has it).  Then one step with an inf planted
    in a gradient must change no master, code, scale or count, and the
    loss scale must follow its scaler (a dynamic one backs off; bf16 O2
    runs none)."""
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn
    from apex_tpu_torch.optim import fused_adam

    log("phase 10: BERT-Large amp O2 training with fp8 Adam moments, "
        "b=16 s=512 P=80")
    dev = torch.device("cuda")
    b, s, p = 16, 512, 80
    cfg = BertConfig.bert_large(dtype=torch.bfloat16, remat=True)
    model = BertModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(5))
    state = amp.initialize(model, fused_adam(
        1e-4, moment_format="fp8_block_scaled"), "O2",
        half_dtype=torch.bfloat16)
    ids, pos, labels = _bert_batch(torch, cfg, b, s, p, 6, dev)

    def loss_of():
        logits, _ = model(ids, mlm_positions=pos)
        return bert_mlm_loss_fn(logits.float(), labels)

    def train_step():
        loss = loss_of()
        state.scale_loss(loss).backward()
        finite = state.apply_gradients()
        return loss.detach(), finite

    def fwd_only():
        with torch.no_grad():
            return loss_of()

    def fwd_bwd():
        loss = loss_of()
        state.scale_loss(loss).backward()
        for q in model.parameters():
            q.grad = None
        return loss.detach()

    for _ in range(warmup):
        train_step()
    torch.cuda.synchronize()
    t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
    t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, outs, host_ms = _event_times(torch, train_step, steps)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o[0]) for o in outs]
    finite = [bool(o[1]) for o in outs]
    t_step = sum(step_ms) / len(step_ms)
    prof = _profile_train(torch, train_step, groups=BERT_GROUPS) \
        if profile else None
    per_step = {k: v / steps for k, v in launches.items()}
    # the skip step: an inf in one gradient of the scaled loss
    loss = loss_of()
    state.scale_loss(loss).backward()
    model.transformer.layers[0].attention.qkv_proj.weight.grad[0, 0] = \
        float("inf")
    st = state.opt_state
    before = [t.clone() for t in _fp8_state_bytes(st, state.groups[0].flat)]
    scale0 = float(state.loss_scale_state.loss_scale)
    skipped = not bool(state.apply_gradients())
    unchanged = all(torch.equal(a, b) for a, b in zip(
        before, _fp8_state_bytes(st, state.groups[0].flat)))
    # bf16 O2 runs no loss scale (NoOpLossScale, as in the JAX package):
    # the skip step backs a dynamic scale off and leaves any other as is
    from apex_tpu_torch.core import StaticLossScale
    scale1 = float(state.loss_scale_state.loss_scale)
    backed_off = (scale1 == scale0 if isinstance(state.loss_scaler,
                                                 StaticLossScale)
                  else scale1 < scale0)
    state_bytes = sum(t.numel() * t.element_size() for t in (
        st.exp_avg[0].q, st.exp_avg[0].scale, st.exp_avg_sq[0].q,
        st.exp_avg_sq[0].scale))
    n_params = state.groups[0].flat.numel()
    del before
    stats = dict(
        samples_per_s=b * steps / (sum(step_ms) / 1e3),
        step_ms=step_ms, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        host_ms_per_step=sum(host_ms) / len(host_ms),
        fwd_ms=t_fwd, bwd_ms=max(t_fb - t_fwd, 0.0),
        opt_ms=max(t_step - t_fb, 0.0), peak_bytes=peak,
        phase4_peak_bytes=dense_peak, moment_state_bytes=state_bytes,
        masters=n_params, loss_first=losses[0], loss_last=losses[-1],
        losses=losses, finite=finite, launches_per_step=per_step,
        launches=launches, skip_step_skipped=skipped,
        skip_step_state_unchanged=unchanged,
        loss_scaler=type(state.loss_scaler).__name__,
        skip_step_scale=(scale0, scale1), skip_step_scale_rule=backed_off)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok = (all(finite) and losses[-1] < losses[0] and skipped and unchanged
          and backed_off)
    for name, want in dict(TRAIN_LAUNCHES, fp8_adam=1).items():
        if per_step[name] != want:
            log(f"  launches of {name}: {per_step[name]} per step, "
                f"expected {want}")
            ok = False
    del model, state, outs, st
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 11: FusedScaleMaskSoftmax as Megatron calls it
# ------------------------------------------------------------------ #
def phase_softmax_chain(torch, reps=5):
    """Scores ``q @ k^T``, probs from ``FusedScaleMaskSoftmax``, context
    ``probs @ v``, forward and backward, at BERT-Large's scores (padding
    mask) and Megatron GPT's (causal); q, k and v gradients against the
    same chain with fusion off (the plain composition) on the card,
    within 1e-2 of each gradient's largest entry (bf16 probabilities one
    ulp apart, through two bf16 products).  One launch of each kernel
    per call."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.transformer import AttnMaskType, FusedScaleMaskSoftmax

    log("phase 11: FusedScaleMaskSoftmax in the Megatron attention chain")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    rel = 1e-2
    ok, stats = True, {"launches": dict.fromkeys(
        ("softmax_fwd", "softmax_bwd"), 0)}
    for tag, (b, h, sq, sk), mtype in (
            ("bert_padding", (16, 16, 512, 512), AttnMaskType.padding),
            ("gpt_causal", (4, 16, 1024, 1024), AttnMaskType.causal)):
        d = 64
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(
            torch.bfloat16) for n in (sq, sk, sk))
        dctx = torch.randn(b, h, sq, d, generator=g, device=dev).to(
            torch.bfloat16)
        mask = None
        if mtype == AttnMaskType.padding:
            lens = torch.randint(sk // 2, sk + 1, (b,), generator=g,
                                 device=dev)
            mask = (torch.arange(sk, device=dev)[None, :]
                    >= lens[:, None]).view(b, 1, 1, sk)

        def chain(fusion):
            sm = FusedScaleMaskSoftmax(mtype, scale=0.125,
                                       scaled_masked_softmax_fusion=fusion)
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            scores = torch.matmul(qq, kk.transpose(-1, -2))
            ctx = torch.matmul(sm(scores, mask), vv)
            return torch.autograd.grad(ctx, (qq, kk, vv), dctx)

        _build.reset_launches()
        got = chain(True)
        counts = {n: _build.launches[n] for n in stats["launches"]}
        ref = chain(False)
        torch.cuda.synchronize()
        errs = {n: float((a.float() - r.float()).abs().max()
                         / r.float().abs().max())
                for n, a, r in zip("qkv", got, ref)}
        good = counts == {"softmax_fwd": 1, "softmax_bwd": 1} and all(
            e <= rel for e in errs.values())
        _build.reset_launches()
        t_k = _event_times(torch, lambda: chain(True), reps)[0]
        for n in stats["launches"]:
            stats["launches"][n] += counts[n] + _build.launches[n]
        t_p = _event_times(torch, lambda: chain(False), reps)[0]
        stats[tag] = dict(shape=(b, h, sq, sk), grad_rel_err=errs,
                          launches_per_call=counts, tolerance=rel,
                          chain_ms_kernel=sorted(t_k)[reps // 2],
                          chain_ms_plain=sorted(t_p)[reps // 2])
        log(f"  {tag}: {json.dumps(stats[tag])}")
        ok &= good
        del q, k, v, dctx, got, ref
        torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 12: the fp8 optimizer, card against CPU
# ------------------------------------------------------------------ #
def phase_fp8_identity(torch, steps=3):
    """A 2-layer BERT-Large-width model takes 3 amp O2 steps with fp8
    moments on the card (kernel B-18) and on the CPU (the plain
    version) from the same weights, fed the same gradients (the card's,
    of the same batch): codes and scales equal or within one e4m3
    quantum of the block scale (the count that differ is reported),
    masters within 1e-6 of each other relative to their size."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn
    from apex_tpu_torch.optim import fused_adam

    log("phase 12: fp8 optimizer identity (BERT-Large width, 2 layers, "
        "amp O2 bf16, 3 steps, card against CPU)")
    dev = torch.device("cuda")
    cfg = BertConfig.bert_large(num_layers=2, dtype=torch.bfloat16)
    gpu = BertModel(cfg, device=dev)
    gpu.init_weights(torch.Generator(device=dev).manual_seed(14))
    cpu = BertModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    states = {name: amp.initialize(m, fused_adam(
        1e-3, moment_format="fp8_block_scaled"), "O2",
        half_dtype=torch.bfloat16) for name, m in (("cuda", gpu),
                                                   ("cpu", cpu))}
    ids, pos, labels = _bert_batch(torch, cfg, 4, 128, 20, 15, dev)
    finite = []
    for _ in range(steps):
        sg = states["cuda"]
        logits, _ = gpu(ids, mlm_positions=pos)
        sg.scale_loss(bert_mlm_loss_fn(logits.float(), labels)).backward()
        grads = [q.grad for q in sg.module_params]
        for q in sg.module_params:
            q.grad = None
        finite.append(bool(sg.apply_gradients(grads)))
        finite.append(bool(states["cpu"].apply_gradients(
            [None if gr is None else gr.cpu() for gr in grads])))
    torch.cuda.synchronize()
    sg, sc = states["cuda"], states["cpu"]
    lay = sg.opt_state.layouts[0]
    out = dict(masters=lay.numel, padded=lay.total, finite=finite)
    good = all(finite) and lay.leaves == sc.opt_state.layouts[0].leaves
    for field in ("exp_avg", "exp_avg_sq"):
        mg, mc = getattr(sg.opt_state, field)[0], getattr(sc.opt_state,
                                                          field)[0]
        qg, qc = mg.q.cpu(), mc.q
        sgc = mg.scale.cpu()
        differ = int((qg.view(torch.uint8) != qc.view(torch.uint8)).sum())
        s_rel = float(((sgc - mc.scale).abs() / mc.scale).max())
        # one quantum: the e4m3 spacing at the larger code, in the scale
        a = (qg.float().view(-1, 256) * sgc[:, None]).reshape(-1)
        c = (qc.float().view(-1, 256) * mc.scale[:, None]).reshape(-1)
        s = torch.maximum(sgc, mc.scale).repeat_interleave(256)
        mag = torch.maximum(a.abs(), c.abs()) / s
        quantum = torch.where(mag >= 2.0 ** -6, torch.exp2(torch.floor(
            torch.log2(mag.clamp_min(1e-30))) - 3), torch.full_like(
                mag, 2.0 ** -9)) * s
        within = bool(((a - c).abs() <= quantum * (1 + 1e-6)
                       + 448 * (sgc - mc.scale).abs().repeat_interleave(
                           256)).all())
        out[field] = dict(codes_differ=differ, codes=qg.numel(),
                          scales_differ=int((sgc != mc.scale).sum()),
                          scale_max_rel_diff=s_rel,
                          within_one_quantum=within)
        good &= within and s_rel <= 1e-6
    pg, pc = sg.groups[0].flat.cpu(), sc.groups[0].flat
    m_err = float(((pg - pc).abs() / pc.abs().clamp_min(1e-3)).max())
    out.update(master_max_rel_diff=m_err,
               masters_differ=int((pg != pc).sum()),
               count=(int(sg.opt_state.count), int(sc.opt_state.count)))
    good &= m_err <= 1e-6 and out["count"] == (steps, steps)
    log(f"  {json.dumps(out)}")
    del gpu, cpu, states
    torch.cuda.empty_cache()
    return good, out


# ------------------------------------------------------------------ #
# phase 13: GroupNorm and the attention block at full width
# ------------------------------------------------------------------ #
GN_KERNELS = ("group_norm_fwd", "group_norm_bwd", "group_norm_fwd_3pass",
              "group_norm_bwd_3pass")
MHA_KERNELS = ("layer_norm", "layer_norm_bwd", "flash_attention_fwd",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def _fwd_bwd(torch, module, inputs, dy, **kw):
    """Output and the gradients of ``inputs`` and of every parameter of
    one forward and backward of ``module``."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = module(*ins, **kw)
    params = [p for _, p in module.named_parameters()]
    grads = torch.autograd.grad(out, ins + params, dy)
    return out.detach(), grads


def _kernels_per_call(torch, fn, reps=50):
    """Device ms per call of ``fn`` between CUDA events with the host's
    enqueue hidden (:func:`queued_event_ms`), and the CUDA kernels a call
    (torch.profiler over ``reps`` calls; a short window of module calls
    lost about a third of its kernel events on the card)."""
    from torch.profiler import ProfilerActivity, profile

    ms = queued_event_ms(torch, fn, 15)   # ~1 ms of enqueue a call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _is_kernel(e)]
    return ms, sum(e.count for e in events) / reps


def _grad_rel(torch, got, ref):
    """Largest difference of each gradient over its largest entry."""
    return [float((a.float() - r.float()).abs().max()
                  / max(float(r.float().abs().max()), 1e-30))
            for a, r in zip(got, ref)]


def _plain_twin(module, cls, *args, **kw):
    """The same module on the plain path (``implementation="torch"``),
    with the same parameters."""
    twin = cls(*args, implementation="torch", **kw)
    twin.load_state_dict(module.state_dict())
    return twin


def phase_group_norm_block(torch, reps=10, warmup=3):
    """(a) ``GroupNorm(32, 512, act="silu")`` at (8, 64, 64, 512) bf16,
    forward and backward: ms per call over 10 timed calls after 3 warm-up
    ones, launches of each GroupNorm kernel per call (one each, on the
    cluster route), device ms per call (CUDA events, the enqueue hidden)
    and CUDA kernels per call (torch.profiler);
    then ``GroupNorm(32, 128, act="silu")`` at a VAE decoder's (1, 512,
    512, 128) bf16, on the three-pass route, the same way.  (b)
    ``SelfMultiheadAttn`` at BERT-Large width (E = 1024, 16 heads, d = 64),
    bias, ``include_norm_add``, a boolean key-padding mask, b = 16, s =
    512, bf16, forward and backward; then one causal call.  (c)
    ``EncdecMultiheadAttn`` (q 512, kv 512) and ``FusedDenseGeluDense(4096,
    1024)`` on the same activations.  Gradients of the inputs and of every
    parameter against the plain path on the card (the same modules with
    ``implementation="torch"``; the dense block, which has no kernel,
    against its fp32 computation of the same bf16 values): within 2e-2 of
    each gradient's largest entry for the attention (bf16 probabilities
    and dS rounded at other points than in the plain composition, through
    bf16 products) and the dense block (its bf16 products round the
    hidden activation and each gradient, the fp32 twin rounds none), 1e-2
    for GroupNorm (one bf16 rounding of an fp32 result).  Launches per call: each GroupNorm kernel
    once in (a); LayerNorm forward and backward and the three flash
    kernels once each in (b) and (c)'s self/encdec calls (no LayerNorm
    without ``include_norm_add``)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import (
        EncdecMultiheadAttn, FusedDenseGeluDense, GroupNorm,
        SelfMultiheadAttn)

    log("phase 13: GroupNorm(+SiLU) and the attention block at full width")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    ok, stats = True, {"launches": dict.fromkeys(GN_KERNELS + MHA_KERNELS,
                                                 0)}

    def timed_calls(fn):
        for _ in range(warmup):
            fn()
        _build.reset_launches()
        t, _, host = _event_times(torch, fn, reps)
        counts = {k: _build.launches[k] for k in stats["launches"]}
        for k, v in counts.items():
            stats["launches"][k] += v
        return sorted(t)[reps // 2], sum(host) / reps, {
            k: v / reps for k, v in counts.items() if v}

    def check(tag, module, twin, inputs, dy, rel, expect, twin_dtype=bf,
              **kw):
        nonlocal ok
        _build.reset_launches()
        out, got = _fwd_bwd(torch, module, inputs, dy, **kw)
        counts = {k: _build.launches[k] for k in stats["launches"]}
        for k, v in counts.items():
            stats["launches"][k] += v
        ref_out, ref = _fwd_bwd(torch, twin, [t.to(twin_dtype)
                                              for t in inputs],
                                dy.to(twin_dtype), **kw)
        torch.cuda.synchronize()
        errs = _grad_rel(torch, got, ref)
        out_err = _grad_rel(torch, [out], [ref_out])[0]
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *got))
        fired = {k: v for k, v in counts.items() if v}
        good = (finite and max(errs) <= rel and out_err <= rel
                and fired == expect)
        stats[tag] = dict(out_rel_err=out_err, worst_grad_rel_err=max(errs),
                          grads=len(errs), tolerance=rel,
                          launches_per_call=fired, expected=expect)
        log(f"  {tag}: {json.dumps(stats[tag])}")
        ok &= good

    # (a) the GroupNorm module at the repo's GN cell
    gn = GroupNorm(32, 512, act="silu", device=dev)
    with torch.no_grad():
        gn.scale.copy_(1 + 0.2 * torch.randn(512, generator=g, device=dev))
        gn.bias.copy_(0.1 * torch.randn(512, generator=g, device=dev))
    x = torch.randn(8, 64, 64, 512, generator=g, device=dev).to(bf)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
    check("group_norm", gn, _plain_twin(gn, GroupNorm, 32, 512, act="silu",
                                        device=dev),
          [x], dy, 1e-2, {"group_norm_fwd": 1, "group_norm_bwd": 1})
    ms, host, per = timed_calls(lambda: _fwd_bwd(torch, gn, [x], dy))
    dev_ms, kernels = _kernels_per_call(
        torch, lambda: _fwd_bwd(torch, gn, [x], dy))
    stats["group_norm"].update(ms_per_call=ms, host_ms_per_call=host,
                               launches_timed=per, shape=list(x.shape),
                               device_ms_per_call=dev_ms,
                               cuda_kernels_per_call=kernels)
    log(f"  group_norm fwd+bwd: {ms:.4f} ms per call (host {host:.4f}), "
        f"device {dev_ms:.5f} ms in {kernels:g} CUDA kernels, launches "
        f"per call {per}")
    del x, dy
    # a VAE decoder's last GroupNorm: no cluster holds its slab
    vae = GroupNorm(32, 128, act="silu", device=dev)
    with torch.no_grad():
        vae.scale.copy_(1 + 0.2 * torch.randn(128, generator=g, device=dev))
        vae.bias.copy_(0.1 * torch.randn(128, generator=g, device=dev))
    x = torch.randn(1, 512, 512, 128, generator=g, device=dev).to(bf)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
    check("group_norm_vae", vae, _plain_twin(vae, GroupNorm, 32, 128,
                                             act="silu", device=dev),
          [x], dy, 1e-2, {"group_norm_fwd_3pass": 1,
                          "group_norm_bwd_3pass": 1})
    ms, host, per = timed_calls(lambda: _fwd_bwd(torch, vae, [x], dy))
    dev_ms, kernels = _kernels_per_call(
        torch, lambda: _fwd_bwd(torch, vae, [x], dy))
    stats["group_norm_vae"].update(ms_per_call=ms, host_ms_per_call=host,
                                   launches_timed=per, shape=list(x.shape),
                                   device_ms_per_call=dev_ms,
                                   cuda_kernels_per_call=kernels)
    log(f"  group_norm_vae fwd+bwd: {ms:.4f} ms per call (host "
        f"{host:.4f}), device {dev_ms:.5f} ms in {kernels:g} CUDA kernels, "
        f"launches per call {per}")
    del x, dy

    # (b) self-attention at BERT-Large width
    b, s, e, h = 16, 512, 1024, 16
    x = torch.randn(b, s, e, generator=g, device=dev).to(bf)
    dy = torch.randn(b, s, e, generator=g, device=dev).to(bf)
    lens = torch.randint(s // 2, s + 1, (b,), generator=g, device=dev)
    kp = torch.arange(s, device=dev)[None, :] >= lens[:, None]
    attn = SelfMultiheadAttn(e, h, bias=True, include_norm_add=True,
                             device=dev)
    with torch.no_grad():
        for p in (attn.ln_scale, attn.ln_bias, attn.qkv_proj.bias,
                  attn.out_proj.bias):
            p.add_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    attn_plain = _plain_twin(attn, SelfMultiheadAttn, e, h, bias=True,
                             include_norm_add=True, device=dev)
    three = {k: 1 for k in MHA_KERNELS}
    check("self_attn", attn, attn_plain, [x], dy, 2e-2, three,
          key_padding_mask=kp)
    ms, host, per = timed_calls(lambda: _fwd_bwd(
        torch, attn, [x], dy, key_padding_mask=kp))
    stats["self_attn"].update(ms_per_call=ms, host_ms_per_call=host,
                              launches_timed=per)
    causal = SelfMultiheadAttn(e, h, bias=True, include_norm_add=True,
                               causal=True, device=dev)
    causal.load_state_dict(attn.state_dict())
    check("self_attn_causal", causal, _plain_twin(
        causal, SelfMultiheadAttn, e, h, bias=True, include_norm_add=True,
        causal=True, device=dev), [x], dy, 2e-2, three)
    log(f"  self_attn fwd+bwd: {ms:.4f} ms per call (host {host:.4f})")

    # (c) encoder-decoder attention and the dense-GELU-dense block
    kv = torch.randn(b, s, e, generator=g, device=dev).to(bf)
    enc = EncdecMultiheadAttn(e, h, bias=True, device=dev)
    no_ln = {k: 1 for k in MHA_KERNELS if not k.startswith("layer_norm")}
    check("encdec_attn", enc, _plain_twin(enc, EncdecMultiheadAttn, e, h,
                                          bias=True, device=dev),
          [x, kv], dy, 2e-2, no_ln, key_padding_mask=kp)
    ms, host, _ = timed_calls(lambda: _fwd_bwd(
        torch, enc, [x, kv], dy, key_padding_mask=kp))
    stats["encdec_attn"].update(ms_per_call=ms, host_ms_per_call=host)
    mlp = FusedDenseGeluDense(4096, 1024, device=dev)
    mlp32 = FusedDenseGeluDense(4096, 1024, device=dev)
    mlp32.load_state_dict(mlp.state_dict())
    check("dense_gelu_dense", mlp, mlp32, [x], dy, 2e-2, {},
          twin_dtype=torch.float32)
    ms, host, _ = timed_calls(lambda: _fwd_bwd(torch, mlp, [x], dy))
    stats["dense_gelu_dense"].update(ms_per_call=ms, host_ms_per_call=host)
    log(f"  encdec / dense block fwd+bwd: "
        f"{stats['encdec_attn']['ms_per_call']:.4f} / {ms:.4f} ms per call")
    del x, dy, kv
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 14: a diffusion-style spatial block, card against CPU
# ------------------------------------------------------------------ #
def phase_block_identity(torch):
    """GroupNorm(32)+SiLU, then ``SelfMultiheadAttn(include_norm_add)``
    over the H·W tokens, then ``FusedDenseGeluDense``, at C = 512, 8
    heads, 16x16 spatial, b = 2, fp32 with TF32 off: the output and every
    gradient (input and parameters) on the card — the GroupNorm,
    LayerNorm and flash kernels — equal the CPU's plain path within 1e-4
    of each one's largest entry (fp32 sums in another order, through
    three layers)."""
    from apex_tpu_torch.ops import (
        FusedDenseGeluDense, GroupNorm, SelfMultiheadAttn)

    log("phase 14: spatial block identity (GroupNorm+SiLU, self-attention "
        "with norm-add, dense-GELU-dense; C=512, 16x16, b=2, fp32)")
    dev = torch.device("cuda")
    c, heads, groups, b, hw = 512, 8, 32, 2, 16

    class Block(torch.nn.Module):
        def __init__(self, device):
            super().__init__()
            self.gn = GroupNorm(groups, c, act="silu", device=device)
            self.attn = SelfMultiheadAttn(c, heads, bias=True,
                                          include_norm_add=True,
                                          device=device)
            self.mlp = FusedDenseGeluDense(4 * c, c, device=device)

        def forward(self, x):
            t = self.gn(x).reshape(x.shape[0], -1, c)
            return self.mlp(self.attn(t)).reshape(x.shape)

    g = torch.Generator(device=dev).manual_seed(19)
    gpu = Block(dev)
    with torch.no_grad():
        for p in gpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g, device=dev))
    cpu = Block("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = torch.randn(b, hw, hw, c, generator=g, device=dev)
    dy = torch.randn(x.shape, generator=g, device=dev)
    out_g, grads_g = _fwd_bwd(torch, gpu, [x], dy)
    out_c, grads_c = _fwd_bwd(torch, cpu, [x.cpu()], dy.cpu())
    rel = 1e-4
    errs = _grad_rel(torch, [t.cpu() for t in grads_g], grads_c)
    names = ["x"] + [n for n, _ in gpu.named_parameters()]
    out_err = _grad_rel(torch, [out_g.cpu()], [out_c])[0]
    worst = max(zip(errs, names))
    ok = out_err <= rel and worst[0] <= rel
    stats = dict(out_rel_err=out_err, grads=len(errs), worst_grad=worst[1],
                 worst_grad_rel_err=worst[0], tolerance=rel)
    log(f"  {json.dumps(stats)}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 8: ResNet-50 amp O2 training with the fused BatchNorm
# ------------------------------------------------------------------ #
# device-time groups of a ResNet step under --profile (kernel names;
# "convs" also takes the classifier's one small GEMM)
RESNET_GROUPS = {
    "bn_kernels": r"bn_(partials|finalize|apply|bwd_dx)_kernel",
    "convs": r"(?i)conv|cudnn|xmma|implicit|dgrad|wgrad|fprop|nhwc|nchw"
             r"|sm90_|cutlass|gemm",
}


def _resnet_loss(torch, logits, onehot):
    """``examples/imagenet/main_amp.py``'s loss: -mean(Σ log_softmax ·
    onehot), in fp32."""
    return -(torch.log_softmax(logits.float(), dim=-1) * onehot).sum(
        -1).mean()


def phase_resnet(torch, profile=False, steps=10, warmup=3, b=128, size=224,
                 opt_level="O2"):
    """Phase 8 (amp O2) and phase 15 (``opt_level="O1"``, amp's default
    level, as ``bench_configs.py``'s ``resnet50_o1``): the same model,
    batch and step; under O1 the stored parameters must be the module's
    own fp32 ones, with no masters."""
    import torch.nn.functional as F

    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import resnet50
    from apex_tpu_torch.optim import fused_sgd

    log(f"phase {8 if opt_level == 'O2' else 15}: ResNet-50 amp "
        f"{opt_level} training (bf16, fused BN, s2d stem, FusedSGD), "
        f"b={b}, {size}x{size}")
    dev = torch.device("cuda")
    # the reference's examples/imagenet sets cudnn.benchmark; the warm-up
    # steps pay its search
    bench_was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    model = resnet50(dtype=torch.bfloat16, fused_bn=True, stem="s2d")
    model.init_weights(torch.Generator(device=dev).manual_seed(9))
    state = amp.initialize(model, fused_sgd(0.1, momentum=0.9,
                                            weight_decay=1e-4), opt_level)
    g = torch.Generator(device=dev).manual_seed(10)
    images = torch.randn(b, size, size, 3, generator=g, device=dev)
    labels = torch.randint(0, 1000, (b,), generator=g, device=dev)
    onehot = F.one_hot(labels, 1000).float()

    def loss_of():
        return _resnet_loss(torch, model(images), onehot)

    def train_step():
        loss = loss_of()
        state.scale_loss(loss).backward()
        finite = state.apply_gradients()
        return loss.detach(), finite

    def fwd_only():
        with torch.no_grad():
            return loss_of()

    def fwd_bwd():
        loss = fwd_bwd_kept()
        for q in model.parameters():
            q.grad = None
        return loss

    def fwd_bwd_kept():
        loss = loss_of()
        state.scale_loss(loss).backward()
        return loss.detach()

    t0 = time.monotonic()
    warm_losses = [float(train_step()[0]) for _ in range(warmup)]
    warm_s = time.monotonic() - t0
    t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
    t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, outs, host_ms = _event_times(torch, train_step, steps)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o[0]) for o in outs]
    finite = [bool(o[1]) for o in outs]
    t_step = sum(step_ms) / len(step_ms)
    prof = None
    if profile:
        prof = _profile_train(torch, train_step, groups=RESNET_GROUPS)
        prof["optimizer_device_ms_per_step"] = _optimizer_device_ms(
            torch, fwd_bwd_kept, state.apply_gradients)
    per_step = {k: launches[k] / steps for k in BN_KERNELS}
    stats = dict(
        samples_per_s=b * steps / (sum(step_ms) / 1e3),
        step_ms=step_ms, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        host_ms_per_step=sum(host_ms) / len(host_ms),
        fwd_ms=t_fwd, bwd_ms=max(t_fb - t_fwd, 0.0),
        opt_ms=max(t_step - t_fb, 0.0), peak_bytes=peak, warmup_s=warm_s,
        loss_init=warm_losses[0], warmup_losses=warm_losses,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        finite=finite, launches_per_step=per_step, launches=launches)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    # lr 0.1 with momentum and no warm-up swings the loss after the first
    # updates (on the card: 7.44 at init, 5.51 after two updates, then up
    # to 9.34 and back to 6.47 over the timed ten), so the gate is that
    # training brought the loss below its value at initialisation
    ok = (all(finite) and all(np.isfinite(warm_losses + losses))
          and min(warm_losses[1:] + losses) < warm_losses[0])
    if opt_level == "O1":
        stats["stored_fp32_views_no_masters"] = _fp32_views_no_masters(
            torch, state, model)
        ok &= stats["stored_fp32_views_no_masters"]
    for name in BN_KERNELS:
        if per_step[name] != RESNET_BN_LAUNCHES:
            log(f"  launches of {name}: {per_step[name]} per step, "
                f"expected {RESNET_BN_LAUNCHES}")
            ok = False
    del model, state, outs, images
    torch.backends.cudnn.benchmark = bench_was
    torch.cuda.empty_cache()
    return ok, stats


def _fp32_views_no_masters(torch, state, model):
    """O1's storage: one fp32 flat buffer, no masters, and every module
    parameter an fp32 view of it that the state's params alias."""
    if state.policy.master_weights or len(state.groups) != 1:
        return False
    flat = state.groups[0].flat
    lo = flat.data_ptr()
    hi = lo + flat.numel() * flat.element_size()
    return all(p.dtype == flat.dtype == torch.float32
               and lo <= p.data_ptr() < hi
               and state.params[n].data_ptr() == p.data_ptr()
               for n, p in model.named_parameters())


def _optimizer_device_ms(torch, make_grads, apply, n=2):
    """Device ms of ``apply()`` alone (the optimizer step: flat grads,
    finiteness, FusedSGD, the copy back to the module), each call after
    ``make_grads()`` ran outside the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    total = 0.0
    for _ in range(n):
        make_grads()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            apply()
            torch.cuda.synchronize()
        total += sum(_device_us(e) for e in pr.key_averages()
                     if _is_kernel(e))
    return total / n / 1e3


# ------------------------------------------------------------------ #
# phase 9: ResNet identity, card against CPU
# ------------------------------------------------------------------ #
def phase_resnet_identity(torch):
    import torch.nn.functional as F

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import ResNet, ResNetConfig

    log("phase 9: ResNet identity (stages (1, 1), width 64, 10 classes, "
        "fused BN, fp32, TF32 off, b=4, 64x64)")
    dev = torch.device("cuda")
    rel = 1e-4          # fp32 sums in another order, through two stages
    ok, stats = True, {}
    for stem in ("s2d", "conv"):
        cfg = ResNetConfig(stage_sizes=(1, 1), width=64, num_classes=10,
                           fused_bn=True, stem=stem)
        gpu = ResNet(cfg, device=dev)
        gpu.init_weights(torch.Generator(device=dev).manual_seed(11))
        cpu = ResNet(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        gen = torch.Generator().manual_seed(12)
        x = torch.rand(4, 64, 64, 3, generator=gen)
        onehot = F.one_hot(torch.randint(0, 10, (4,), generator=gen),
                           10).float()
        out = {}
        _build.reset_launches()
        for name, model, d in (("cuda", gpu, dev), ("cpu", cpu, "cpu")):
            logits = model(x.to(d))
            _resnet_loss(torch, logits, onehot.to(d)).backward()
            out[name] = (logits.detach().cpu(),
                         {n: b.cpu() for n, b in model.named_buffers()},
                         {n: q.grad.detach().cpu()
                          for n, q in model.named_parameters()})
        launched = all(_build.launches[k] == 9 for k in BN_KERNELS)
        (lg_g, bf_g, gr_g), (lg_c, bf_c, gr_c) = out["cuda"], out["cpu"]
        logit_err = float((lg_g - lg_c).abs().max() / lg_c.abs().max())
        stat_err = max(float((bf_g[n] - v).abs().max()) for n, v in
                       bf_c.items())
        grad_err = {n: float((gr_g[n] - v).abs().max()
                             / max(float(v.abs().max()), 1e-30))
                    for n, v in gr_c.items()}
        worst = max(grad_err.items(), key=lambda kv: kv[1])
        good = (launched and logit_err <= rel and stat_err <= 1e-5
                and worst[1] <= rel and set(gr_g) == set(gr_c))
        stats[stem] = dict(logits_rel_err=logit_err,
                           running_stats_abs_err=stat_err,
                           grads=len(grad_err), worst_grad=worst[0],
                           worst_grad_rel_err=worst[1],
                           bn_kernels_launched_9_each=launched,
                           tolerance=f"logits and grads {rel} of the "
                                     "largest entry; stats 1e-5")
        ok &= good
        log(f"  {stem}: {json.dumps(stats[stem])}")
        del gpu, cpu, out
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 16: ResNet O1 identity, card against CPU
# ------------------------------------------------------------------ #
def _resnet_o1_step(torch, cfg, sd, x, onehot, dev, level="O1"):
    """One amp ``level`` + FusedSGD step of a ResNet of ``cfg`` loaded with
    ``sd`` on ``dev``: the loss, logits, gradients, parameter changes,
    running statistics, each ReLU'd BN output's sign mask and the stem's
    max-pool choices (where the pooled value is positive), on the CPU."""
    import torch.nn.functional as F

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.optim import fused_sgd

    model = ResNet(cfg, device=dev)
    model.load_state_dict(sd)
    state = amp.initialize(model, fused_sgd(0.1, momentum=0.9,
                                            weight_decay=1e-4), level)
    before = {n: v.detach().cpu().clone() for n, v in state.params.items()}
    outs = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, o, n=n: outs.__setitem__(n, o.detach()))
        for n, m in model.named_modules()
        if getattr(m, "block_act", None) == "relu"]
    logits = model(x.to(dev))
    for h in hooks:
        h.remove()
    loss = _resnet_loss(torch, logits, onehot.to(dev))
    state.scale_loss(loss).backward()
    grads = {n: q.grad.detach().cpu().clone()
             for n, q in model.named_parameters()}
    finite = bool(state.apply_gradients())
    pooled, idx = F.max_pool2d(outs["bn_stem"], 3, 2, 1,
                               return_indices=True)
    return dict(
        loss=float(loss.detach()), logits=logits.detach().cpu(),
        grads=grads, finite=finite,
        change={n: v.detach().cpu() - before[n]
                for n, v in state.params.items()},
        stats={n: b.cpu() for n, b in model.named_buffers()},
        masks={n: (o > 0).cpu() for n, o in outs.items()},
        pool=(pooled > 0).cpu(), pool_idx=idx.cpu(),
        views=(_fp32_views_no_masters(torch, state, model)
               if level == "O1" else None))


def phase_resnet_o1_identity(torch):
    """One amp O1 + FusedSGD step (lr 0.1, momentum 0.9, weight decay
    1e-4) of phase 9's tiny ResNet (fused BN, fp32 compute, TF32 off, b=4,
    64x64, both stems) on the card and on the CPU from the same weights:
    O1's compute copy rounds the convs' and the classifier's weights to
    bf16 in the forward, the BN parameters stay fp32, the gradients land
    on the fp32 parameters, which FusedSGD updates in place.

    - Card against CPU: loss and logits within phase 9's 1e-4 of the
      largest entry, the running statistics within 1e-5.  Every ReLU and
      the stem's max pool decide alike on both, or the decisions that
      differ are counted: a value within fp32 noise (~1e-6) of a ReLU's
      zero or of its pool window's maximum goes one way on each device,
      and moves whole weight gradients by up to a few percent (one such
      flip moved 2.3% at this size, on pre-rounded weights under O0
      too).  Without a flip, every gradient and every parameter's change
      within 1e-4 of the largest entry.
    - O1 against O0 on each device: with cuDNN deterministic, the O0
      step on weights rounded to bf16 beforehand runs the same forward
      bit for bit, so each O1 gradient equals the O0 one rounded to bf16
      (the cast's backward) bit for bit, and the norm parameters' equal
      it.  With phase 9 (O0 card against CPU) this holds the O1 step of
      the card to the CPU's."""
    import torch.nn.functional as F

    from apex_tpu_torch import _build
    from apex_tpu_torch.core.precision import norm_param_filter
    from apex_tpu_torch.models import ResNet, ResNetConfig

    log("phase 16: ResNet O1 identity (stages (1, 1), width 64, 10 "
        "classes, fused BN, bf16 compute copy over fp32 compute, b=4, "
        "64x64)")
    dev = torch.device("cuda")
    rel = 1e-4
    det_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ok, stats = True, {}
    for stem in ("s2d", "conv"):
        cfg = ResNetConfig(stage_sizes=(1, 1), width=64, num_classes=10,
                           fused_bn=True, stem=stem)
        gpu = ResNet(cfg, device=dev)
        gpu.init_weights(torch.Generator(device=dev).manual_seed(11))
        sd = {k: v.cpu() for k, v in gpu.state_dict().items()}
        del gpu
        rounded = {k: (v.bfloat16().float() if v.is_floating_point()
                       and not norm_param_filter(k) else v)
                   for k, v in sd.items()}
        gen = torch.Generator().manual_seed(12)
        x = torch.rand(4, 64, 64, 3, generator=gen)
        onehot = F.one_hot(torch.randint(0, 10, (4,), generator=gen),
                           10).float()
        _build.reset_launches()
        g = _resnet_o1_step(torch, cfg, sd, x, onehot, dev)
        launched = all(_build.launches[k] == 9 for k in BN_KERNELS)
        c = _resnet_o1_step(torch, cfg, sd, x, onehot, "cpu")
        o0 = _resnet_o1_step(torch, cfg, rounded, x, onehot, dev, "O0")

        def worst(a, b):
            errs = {n: float((a[n] - v).abs().max()
                             / max(float(v.abs().max()), 1e-30))
                    for n, v in b.items()}
            return max(errs.items(), key=lambda kv: kv[1])
        flips = sum(int((g["masks"][n] != m).sum())
                    for n, m in c["masks"].items())
        flips += int(((g["pool_idx"] != c["pool_idx"])
                      & (g["pool"] | c["pool"])).sum())
        grad_w, change_w = worst(g["grads"], c["grads"]), \
            worst(g["change"], c["change"])
        o0c = _resnet_o1_step(torch, cfg, rounded, x, onehot, "cpu", "O0")

        def o1_is_rounded_o0(o1, o0):
            return all(torch.equal(v, o0["grads"][n] if norm_param_filter(n)
                                   else o0["grads"][n].bfloat16().float())
                       for n, v in o1["grads"].items())
        o1_o0 = o1_is_rounded_o0(g, o0) and o1_is_rounded_o0(c, o0c)
        st = dict(
            loss_cuda=g["loss"], loss_cpu=c["loss"],
            loss_rel_err=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            logits_rel_err=float((g["logits"] - c["logits"]).abs().max()
                                 / c["logits"].abs().max()),
            running_stats_abs_err=max(float((g["stats"][n] - v).abs().max())
                                      for n, v in c["stats"].items()),
            decisions_that_differ=flips,
            worst_grad=grad_w[0], worst_grad_rel_err=grad_w[1],
            worst_change=change_w[0], worst_change_rel_err=change_w[1],
            o1_grads_bf16_rounded_o0_bitwise=o1_o0,
            bn_kernels_launched_9_each=launched,
            stored_fp32_views_no_masters=g["views"] and c["views"],
            tolerance=f"loss, logits {rel} of the largest entry, stats "
                      f"1e-5; grads and changes {rel} where no ReLU or "
                      "pool decision differs")
        good = (launched and g["finite"] and c["finite"] and o1_o0
                and st["stored_fp32_views_no_masters"]
                and st["loss_rel_err"] <= rel and st["logits_rel_err"] <= rel
                and st["running_stats_abs_err"] <= 1e-5
                and (flips > 0 or (grad_w[1] <= rel and change_w[1] <= rel)))
        ok &= good
        stats[stem] = st
        log(f"  {stem}: {json.dumps(st)}")
    torch.backends.cudnn.deterministic = det_was
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 17: BERT-Large amp O1 training
# ------------------------------------------------------------------ #
_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _forward_gemm_types(torch, forward, path):
    """The input dtypes and shapes of every cuBLAS product (``aten::mm``,
    ``addmm``, ``bmm``, ``baddbmm``) of one ``forward()``, read from the
    profiler's trace (``record_shapes``), and the CUDA kernels it
    launched, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as pr:
        forward()
        torch.cuda.synchronize()
    pr.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    gemms = [(e["name"], e["args"].get("Input type", []),
              e["args"].get("Input Dims", []))
             for e in events if e.get("cat") == "cpu_op"
             and e.get("name") in _GEMM_OPS]
    kernels = sorted({e.key for e in pr.key_averages() if _is_kernel(e)})
    return gemms, kernels


def phase_train_o1(torch, profile=False, steps=10, warmup=3):
    """``bench_configs.py``'s ``bert_o1`` leg: BERT-Large with
    ``dtype=None`` and remat, amp O1 (fp32 parameters, no masters, a bf16
    compute copy with fp32 norms) under ``amp.o1.o1_intercept(bfloat16)``,
    FusedAdam(1e-4), b=16, s=512, 80 masked positions; 3 warm-up and 10
    timed steps with samples/s, host ms a step and peak memory, and the
    launches of phase 4's kernels a step (the same counts).  Gates, from
    the profiler's record of one forward and one training step: every
    product of the half classes (Dense / attention / MLP) runs in bf16 and
    the tied decoder's in fp32 (the embedding's class, as the JAX
    interceptor gives it: its one product takes the vocabulary); every
    LayerNorm kernel, forward and backward, is its fp32 variant and every
    flash kernel its bf16 one; the loss falls."""
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn
    from apex_tpu_torch.optim import fused_adam

    log("phase 17: BERT-Large amp O1 training (dtype=None, o1_intercept "
        "bf16, remat, FusedAdam), b=16 s=512 P=80")
    dev = torch.device("cuda")
    b, s, p = 16, 512, 80
    cfg = BertConfig.bert_large(dtype=None, remat=True)
    model = BertModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(5))
    state = amp.initialize(model, fused_adam(1e-4), "O1")
    ids, pos, labels = _bert_batch(torch, cfg, b, s, p, 6, dev)

    def loss_of():
        with amp.o1.o1_intercept(torch.bfloat16):
            logits, _ = model(ids, mlm_positions=pos)
        return bert_mlm_loss_fn(logits.float(), labels)

    def train_step():
        loss = loss_of()
        state.scale_loss(loss).backward()
        finite = state.apply_gradients()
        return loss.detach(), finite

    warm = [float(train_step()[0]) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, outs, host_ms = _event_times(torch, train_step, steps)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o[0]) for o in outs]
    finite = [bool(o[1]) for o in outs]
    per_step = {k: v / steps for k, v in launches.items()}
    trace = os.path.join("build", "chip_smoke_bert_o1_trace.json")
    os.makedirs("build", exist_ok=True)

    def fwd():
        with torch.no_grad():
            loss_of()
    gemms, fwd_kernels = _forward_gemm_types(torch, fwd, trace)
    _, step_kernels = _forward_gemm_types(torch, train_step, trace)
    vocab = str(cfg.vocab_size)
    half = [t for _, t, d in gemms if vocab not in str(d)]
    decoder = [t for _, t, d in gemms if vocab in str(d)]
    def all_of(types, want):      # the tensor operands (addmm: the bias)
        return all(x == want for x in types if x != "Scalar")
    bf16_gemms = sum(all_of(t, "c10::BFloat16") for t in half)
    fp32_decoder = sum(all_of(t, "float") for t in decoder)
    ln = [k for k in step_kernels
          if re.search(r"\bln_(fwd|bwd)\w*kernel", k)]
    flash = [k for k in step_kernels
             if re.search(r"\bfa_(fwd|bwd)\w*kernel", k)]
    ln_fp32 = bool(ln) and all(re.search(r"ln_\w*kernel<float,", k)
                               for k in ln)
    flash_bf16 = bool(flash) and all("__nv_bfloat16" in k for k in flash)
    stats = dict(
        samples_per_s=b * steps / (sum(step_ms) / 1e3), step_ms=step_ms,
        step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        host_ms_per_step=sum(host_ms) / len(host_ms), peak_bytes=peak,
        loss_init=warm[0], warmup_losses=warm, loss_first=losses[0],
        loss_last=losses[-1], losses=losses, finite=finite,
        launches_per_step=per_step, launches=launches,
        forward_gemms=len(gemms), forward_gemms_bf16=bf16_gemms,
        forward_gemms_half_classes=len(half),
        decoder_gemms_fp32=fp32_decoder, decoder_gemms=len(decoder),
        layer_norm_kernels=ln, flash_kernels=flash,
        layer_norm_fp32=ln_fp32, flash_bf16=flash_bf16,
        forward_kernels=len(fwd_kernels),
        stored_fp32_views_no_masters=_fp32_views_no_masters(torch, state,
                                                            model))
    log(f"  {json.dumps(stats)}")
    if profile:
        stats["profile"] = _profile_train(torch, train_step,
                                          groups=BERT_GROUPS)
        log(f"  profile: {json.dumps(stats['profile'])}")
    ok = (all(finite) and all(np.isfinite(warm + losses))
          and min(losses) < warm[0] and bool(half)
          and bf16_gemms == len(half) and len(decoder) == 1
          and fp32_decoder == 1 and ln_fp32 and flash_bf16
          and stats["stored_fp32_views_no_masters"])
    for name, want in TRAIN_LAUNCHES.items():
        if per_step.get(name) != want:
            log(f"  launches of {name}: {per_step.get(name)} per step, "
                f"expected {want}")
            ok = False
    state.compute_copy.remove()
    del model, state, outs
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 18: the optimizers of optim, at BERT's sizes
# ------------------------------------------------------------------ #
def _bert_leaves(cfg):
    """The per-parameter leaves of a BERT of ``cfg`` (the train state's
    layout), from a model whose parameters are never initialised."""
    from apex_tpu_torch.core.train_state import parameter_leaves
    from apex_tpu_torch.models import BertModel

    return [lf for _, lf in parameter_leaves(BertModel(cfg, device="cpu"))]


def phase_optimizers(torch, steps=3):
    """FusedLAMB, FusedMixedPrecisionLamb (bf16 parameters, fp32
    masters), FusedNovoGrad, FusedAdagrad, LARC around FusedSGD and
    ``clip_grad_norm``, each over one flat buffer of BERT-Large's 3.36e8
    parameters with their leaves (the train state's layout): ms a step by
    CUDA events over 3 steps.  Then one step at BERT-base's parameter
    shapes on the card and on the CPU from the same parameters and
    gradients: parameters (MP-LAMB's masters) and the optimizers' state
    within the tests' rtol 1e-6 / atol 1e-7, MP-LAMB's bf16 parameters
    within one bf16 ulp past that, the clipped gradients and the norm
    within rtol 1e-6."""
    from apex_tpu_torch import optim
    from apex_tpu_torch.models import BertConfig

    log("phase 18: optimizers over BERT-Large's parameters (3 steps each) "
        "and one BERT-base step card vs CPU")
    dev = torch.device("cuda")
    makers = {
        "fused_lamb": (lambda: optim.fused_lamb(1e-3), torch.float32),
        "fused_mixed_precision_lamb": (
            lambda: optim.fused_mixed_precision_lamb(1e-3), torch.bfloat16),
        "fused_novograd": (lambda: optim.fused_novograd(1e-3),
                           torch.float32),
        "fused_adagrad": (lambda: optim.fused_adagrad(1e-2), torch.float32),
        "larc(fused_sgd)": (lambda: optim.larc(optim.fused_sgd(
            0.1, momentum=0.9, weight_decay=1e-4)), torch.float32),
    }

    def init(opt, p, leaves):
        if getattr(opt, "per_leaf", False):
            return opt.init([p], [leaves])
        return opt.init([p])

    large = _bert_leaves(BertConfig.bert_large())
    n = sum(lf.numel for lf in large)
    g = torch.Generator(device=dev).manual_seed(31)
    stats = dict(params=n, ms_per_step={})
    for name, (make, dt) in makers.items():
        opt = make()
        p = (0.02 * torch.randn(n, generator=g, device=dev)).to(dt)
        state = init(opt, p, large)
        grads = [torch.randn(n, generator=g, device=dev).to(dt)
                 for _ in range(steps)]
        it = iter(grads)
        opt.step([grads[0]], state, [p])        # warm-up
        ms = _event_times(torch, lambda: opt.step([next(it)], state, [p]),
                          steps)[0]
        stats["ms_per_step"][name] = ms
        del p, state, grads
        torch.cuda.empty_cache()
    gf = torch.randn(n, generator=g, device=dev)
    optim.clip_grad_norm([gf], 1.0)             # warm-up
    ms = _event_times(torch, lambda: optim.clip_grad_norm([gf], 1.0),
                      steps)[0]
    stats["ms_per_step"]["clip_grad_norm"] = ms
    del gf
    torch.cuda.empty_cache()
    log(f"  ms per step: {json.dumps(stats['ms_per_step'])}")

    base = _bert_leaves(BertConfig.bert_large(hidden_size=768, num_layers=12,
                                              num_heads=12))
    nb = sum(lf.numel for lf in base)
    gen = torch.Generator().manual_seed(32)
    p0 = 0.02 * torch.randn(nb, generator=gen)
    g0 = torch.randn(nb, generator=gen)
    ok, errs = True, {}

    def worst(a, b):
        return float(((a.float().cpu() - b.float()).abs()
                      / (1e-7 + 1e-6 * b.float().abs())).max())
    for name, (make, dt) in makers.items():
        res = {}
        for d in (dev, "cpu"):
            opt = make()
            p = p0.to(dt).to(d)
            state = init(opt, p, base)
            opt.step([g0.to(dt).to(d)], state, [p])
            tensors = [p]
            if name == "fused_mixed_precision_lamb":
                tensors = [state.master_params[0],
                           state.inner.exp_avg[0], state.inner.exp_avg_sq[0]]
            elif name in ("fused_lamb", "fused_novograd"):
                tensors += [state.exp_avg[0], state.exp_avg_sq[0]]
            elif name == "fused_adagrad":
                tensors += [state.sum_sq[0]]
            else:
                tensors += [state.inner.momentum_buf[0]]
            res[str(d)] = (p, tensors)
        (pg, tg), (pc, tc) = res["cuda"], res["cpu"]
        # ratio to the tolerance atol + rtol |ref|: at most 1 passes
        errs[name] = max(worst(a, b) for a, b in zip(tg, tc))
        ok &= errs[name] <= 1.0
        if dt == torch.bfloat16:
            # the masters rounded: one bf16 ulp (of the larger magnitude)
            # past the masters' own tolerance (near zero it is the atol)
            got, ref = pg.cpu().float(), pc.float()
            mag = torch.maximum(got.abs(), ref.abs())
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(
                min=2.0 ** -126))) - 7)
            errs[name + " bf16 params"] = float(((got - ref).abs() / (
                ulp + 1e-7 + 1e-6 * ref.abs())).max())
            ok &= errs[name + " bf16 params"] <= 1.0
        del res
    gg, gc = g0.to(dev), g0.clone()
    (cg,), ng = optim.clip_grad_norm([gg], 1.0)
    (cc,), nc = optim.clip_grad_norm([gc], 1.0)
    errs["clip_grad_norm"] = max(worst(cg, cc), worst(ng, nc))
    ok &= errs["clip_grad_norm"] <= 1.0
    stats.update(base_params=nb, card_vs_cpu_err_over_tolerance=errs,
                 tolerance="|card - cpu| <= 1e-7 + 1e-6 |cpu| (ratio <= 1); "
                           "MP-LAMB's bf16 params one ulp past it")
    log(f"  card vs CPU (error / tolerance): {json.dumps(errs)}")
    torch.cuda.empty_cache()
    return ok, stats


# ------------------------------------------------------------------ #
# phase 19: GroupNorm at any batch and on strided inputs
# ------------------------------------------------------------------ #
def phase_group_norm_faults(torch):
    """The three-pass kernels at a batch past a grid's 65535 (65537, 4x4,
    320) bf16 — about 0.7 GB an operand, groups of 10 channels — forward
    and backward against their plain versions (phase 1's tolerances, the
    plain backward from the plain statistics); then ``group_norm`` on a
    permuted NCHW view ``x.permute(0, 2, 3, 1)`` of (8, 320, 64, 64) bf16
    against the call on a contiguous copy: the output and the gradient
    reaching the NCHW tensor bit for bit, the kernels launched (one
    forward and one backward a call)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import group_norm
    from apex_tpu_torch.ops.group_norm import (
        group_norm_bwd_kernel, group_norm_bwd_reference,
        group_norm_fwd_kernel, group_norm_fwd_reference)

    log("phase 19: GroupNorm at batch 65537 (three passes) and on a "
        "permuted NCHW view")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)
    n, rows, c, grp = 65537, 16, 320, 32
    x = torch.randn(n, rows, c, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(n, rows, c, generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    _build.reset_launches()
    y, mean, rstd = group_norm_fwd_kernel(x, w, b, grp, 1e-5, True)
    y_p, mean_p, rstd_p = group_norm_fwd_reference(x, w, b, grp, 1e-5, True)
    dx, dw, db = group_norm_bwd_kernel(dy, x, w, b, mean_p, rstd_p, grp,
                                       True)
    fired = {k: v for k, v in _build.launches.items() if v}
    dx_p, dw_p, db_p = group_norm_bwd_reference(dy, x, w, b, mean_p,
                                                rstd_p, grp, True)
    floor = 2 ** -16
    big = dict(
        shape=[n, rows, c], launches=fired,
        y_ok=bf16_ulp_ok(torch, y, y_p, floor * float(
            y_p.float().abs().max())),
        stats_ok=bool(((mean - mean_p).abs() <= 1e-6 * torch.clamp_min(
            mean_p.abs(), 1.0)).all()) and bool(
                ((rstd - rstd_p).abs() <= 1e-5 * rstd_p).all()),
        dx_ok=bf16_ulp_ok(torch, dx, dx_p, floor * float(
            dx_p.float().abs().max())),
        dgamma_dbeta_err=max(float((a - r).abs().max() / r.abs().max())
                             for a, r in ((dw, dw_p), (db, db_p))))
    del x, dy, y, y_p, dx, dx_p
    torch.cuda.empty_cache()
    good_big = (big["y_ok"] and big["stats_ok"] and big["dx_ok"]
                and big["dgamma_dbeta_err"] <= 2e-5
                and fired == {"group_norm_fwd_3pass": 1,
                              "group_norm_bwd_3pass": 1})
    nchw = torch.randn(8, 320, 64, 64, generator=g,
                       device=dev).to(torch.bfloat16)
    dyv = torch.randn(8, 64, 64, 320, generator=g,
                      device=dev).to(torch.bfloat16)
    _build.reset_launches()
    a = nchw.clone().requires_grad_()
    yv = group_norm(a.permute(0, 2, 3, 1), grp, w, b, act="silu")
    (ga,) = torch.autograd.grad(yv, a, dyv)
    view_launches = {k: v for k, v in _build.launches.items() if v}
    cc = nchw.permute(0, 2, 3, 1).contiguous().requires_grad_()
    yc = group_norm(cc, grp, w, b, act="silu")
    (gc,) = torch.autograd.grad(yc, cc, dyv)
    view = dict(shape=list(nchw.shape), launches=view_launches,
                y_bitwise=torch.equal(yv, yc),
                grad_bitwise=torch.equal(ga, gc.permute(0, 3, 1, 2)))
    good_view = (view["y_bitwise"] and view["grad_bitwise"]
                 and sum(view_launches.values()) == 2)
    stats = dict(batch_65537=big, permuted_view=view,
                 tolerance="bf16 one ulp + 2^-16 of max|.|; mean 1e-6, "
                           "rstd 1e-5; dγ/dβ 2e-5 of the largest entry")
    log(f"  {json.dumps(stats)}")
    del nchw, dyv, a, cc
    torch.cuda.empty_cache()
    return good_big and good_view, stats


# ------------------------------------------------------------------ #
# phase 20: remat policies, BERT-Large amp O2
# ------------------------------------------------------------------ #
REMAT_POLICIES = (
    # (name, config fields, flash-forward launches a step over 24 layers)
    ("nothing_saveable", dict(remat_policy="nothing_saveable"), 48),
    ("save_only:attn_out,attn_lse",
     dict(remat_policy="save_only:attn_out,attn_lse"), 24),
    ("dots_with_no_batch_dims_saveable",
     dict(remat_policy="dots_with_no_batch_dims_saveable"), 48),
    ("remat_skip_every=2", dict(remat_skip_every=2), 36),
)


def phase_remat(torch, steps=3):
    """Phase 4's BERT-Large amp O2 step (model, weights, batch,
    FusedAdam) for ``steps`` steps under each remat policy: losses and
    every gradient of every step bit for bit equal to
    ``nothing_saveable``'s (the kernels and cuBLAS rerun bitwise on the
    same inputs; a difference is reported with its size), flash-forward
    launches a step 48 / 24 / 48 / 36, and each policy's peak memory.
    The prediction for ``save_only`` is stated before the runs: 24
    layers keep the forward's ``o`` (b·s·h·d bf16) and ``lse`` (b·h·s
    fp32)."""
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import BertConfig, BertModel, bert_mlm_loss_fn
    from apex_tpu_torch.optim import fused_adam

    b, s, p = 16, 512, 80
    predicted = 24 * b * s * (1024 * 2 + 16 * 4)
    log(f"phase 20: remat policies, BERT-Large amp O2, b={b} s={s} P={p}, "
        f"{steps} steps each; predicted: save_only:attn_out,attn_lse keeps "
        f"{predicted / 1e9:.4f} GB more than nothing_saveable (24 x "
        f"{b}*{s}*(1024*2 + 16*4) B)")
    dev = torch.device("cuda")
    ok, stats, ref = True, {}, None
    for name, kw, want in REMAT_POLICIES:
        cfg = BertConfig.bert_large(dtype=torch.bfloat16, remat=True, **kw)
        model = BertModel(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(5))
        state = amp.initialize(model, fused_adam(1e-4), "O2",
                               half_dtype=torch.bfloat16)
        ids, pos, labels = _bert_batch(torch, cfg, b, s, p, 6, dev)
        _build.reset_launches()
        losses, grads, held, fb_peak, step_peak, wall = [], [], [], [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            logits, _ = model(ids, mlm_positions=pos)
            loss = bert_mlm_loss_fn(logits.float(), labels)
            held.append(torch.cuda.memory_allocated() - before)
            state.scale_loss(loss).backward()
            fb_peak.append(torch.cuda.max_memory_allocated())
            grads.append({n: q.grad.detach().to("cpu")
                          for n, q in model.named_parameters()
                          if q.grad is not None})
            state.apply_gradients()
            losses.append(loss.detach().cpu())
            step_peak.append(torch.cuda.max_memory_allocated())
            wall.append((time.perf_counter() - t0) * 1e3)
        peak = max(step_peak)
        launches = dict(_build.launches)
        flash = launches.get("flash_attention_fwd", 0) / steps
        # the step's peak is the optimizer's (its flat fp32 temporaries,
        # the same under every policy); what a policy keeps shows in the
        # bytes the forward leaves allocated and the fwd+bwd peak
        st = dict(peak_bytes=peak, fwd_bwd_peak_bytes=max(fb_peak),
                  held_after_forward_bytes=max(held),
                  flash_fwd_launches_per_step=flash,
                  expected_flash_fwd=want,
                  # the first step of the first policy pays first calls
                  ms_per_step_incl_copies=wall,
                  losses=[float(x) for x in losses], launches=launches)
        if ref is None:
            ref = (losses, grads, st)
        else:
            same_loss = all(torch.equal(a, c) for a, c in zip(losses, ref[0]))
            diff = max(float((g[n].float() - r[n].float()).abs().max())
                       for g, r in zip(grads, ref[1]) for n in r)
            same = same_loss and diff == 0.0 and all(
                set(g) == set(r) for g, r in zip(grads, ref[1]))
            st.update(bitwise_equal_to_nothing_saveable=same,
                      largest_grad_difference=diff,
                      peak_above_nothing_saveable=peak
                      - ref[2]["peak_bytes"],
                      held_above_nothing_saveable=st[
                          "held_after_forward_bytes"]
                      - ref[2]["held_after_forward_bytes"],
                      fwd_bwd_peak_above_nothing_saveable=st[
                          "fwd_bwd_peak_bytes"]
                      - ref[2]["fwd_bwd_peak_bytes"])
            if not same:
                log(f"  {name}: NOT bitwise equal to nothing_saveable "
                    f"(losses equal {same_loss}, largest gradient "
                    f"difference {diff:g})")
            ok &= gate(f"{name} bitwise equal to nothing_saveable", same)
        ok &= gate(f"{name} flash-forward launches a step {flash}, "
                   f"expected {want}", flash == want)
        stats[name] = st
        log(f"  {name}: {json.dumps({k: v for k, v in st.items() if k != 'launches'})}")
        del model, state, grads, logits, loss
        torch.cuda.empty_cache()
    stats["predicted_save_only_extra_bytes"] = predicted
    stats["launches"] = stats["nothing_saveable"]["launches"]
    return ok, stats


# ------------------------------------------------------------------ #
# phases 21, 22: Mistral-7B and Mixtral-8x7B generate
# ------------------------------------------------------------------ #
LOGIT_REL = 0.05    # bf16 through 32 layers, two attention paths


def _decode_run(torch, model, ids, new):
    """Prefill ``ids`` in one call, then ``new - 1`` greedy decode steps,
    timed: (tokens (b, new), step logits (b, new, vocab) fp32, TTFT s,
    decode s, launches of the run)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import apply_decode, init_cache, prefill_tokens

    cache = init_cache(model, ids.shape[0])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    last, cache = prefill_tokens(model, cache, ids, 0)
    tok = torch.argmax(last.float(), dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    prefill = dict(_build.launches)
    steps, toks = [last.float()], [tok]
    t1 = time.perf_counter()
    for _ in range(new - 1):
        lg, cache = apply_decode(model, cache, tok[:, None])
        steps.append(lg[:, -1].float())
        tok = torch.argmax(steps[-1], dim=-1).to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    dec = time.perf_counter() - t1
    return (torch.stack(toks, 1), torch.stack(steps, 1), ttft, dec,
            prefill, dict(_build.launches))


def _first_flip(torch, a, b, step_logits, tie_rel=0.02):
    """Rows whose greedy tokens ``a`` and ``b`` part, with whether each
    first parting is a near tie in ``step_logits`` (the top logit and
    the other run's choice within ``tie_rel`` of the row's largest
    magnitude)."""
    out = []
    for r in range(a.shape[0]):
        diff = (a[r] != b[r]).nonzero()
        if diff.numel() == 0:
            continue
        j = int(diff[0])
        row = step_logits[r, j]
        gap = float(row.max() - row[int(b[r, j])])
        out.append(dict(row=r, step=j, gap=gap,
                        near_tie=gap <= tie_rel * float(row.abs().max())))
    return out


class _Routes:
    """Forward hooks on a model's MoE layers recording, per layer, the
    ``top_k`` experts each token is routed to (sorted): a list of
    ``(b, s, k)`` tensors a layer, one a call."""

    def __init__(self, torch, model):
        self.torch = torch
        self.layers = [m for m in model.modules() if hasattr(m, "moe_mlp")]
        self.calls = [[] for _ in self.layers]

    def __enter__(self):
        torch = self.torch

        def hook(i):
            def record(m, args, out):
                lg = torch.einsum("gsh,he->gse", args[0].float(),
                                  m.gate.float())
                self.calls[i].append(lg.topk(m.cfg.top_k, dim=-1).indices
                                     .sort(dim=-1).values)
            return record
        self.handles = [layer.moe_mlp.register_forward_hook(hook(i))
                        for i, layer in enumerate(self.layers)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def stacked(self):
        """``(layers, b, s, k)`` over the recorded calls in order."""
        return self.torch.stack([self.torch.cat(c, dim=1)
                                 for c in self.calls])


def _logits_check(torch, model, ids, toks, steps, routes, rel):
    """A greedy decode of ``ids`` (its tokens, step logits and router
    decisions, a :class:`_Routes`) against a full-sequence forward over
    the same ids: each step's logits within ``rel`` of the full
    forward's largest entry.  Under MoE a router decision that differs
    between the two (noise on a near tie of two experts) sends a token
    to another expert and changes every later step of its row, so the
    gate holds the steps before a row's first differing decision, counts
    the decisions that differ, and needs at least one step to hold."""
    (b, plen), new, dev = ids.shape, toks.shape[1], ids.device
    out = torch.cat([ids, toks], dim=1)
    with torch.no_grad(), _Routes(torch, model) as full_routes:
        full = model(out[:, :-1])[:, plen - 1:].float()
    clean = torch.ones(b, new, dtype=torch.bool, device=dev)
    flips = 0
    if full_routes.layers:
        differ = (routes.stacked() != full_routes.stacked()).any(-1)
        flips = int(differ.sum())
        row = differ.any(0)                                   # (b, S)
        first = torch.where(row.any(1), row.float().argmax(1),
                            torch.full((b,), row.shape[1], device=dev))
        clean = (plen - 1 + torch.arange(new, device=dev))[None] \
            < first[:, None]
    pick = clean[..., None].expand_as(steps)
    err, within = (_close_rel(torch, steps[pick], full[pick], rel)
                   if bool(clean.any()) else (float("nan"), False))
    return dict(max_abs_err=err, full_forward_max_abs_logit=float(
                    full.abs().max()), tol=f"{rel} x max |ref|",
                steps_checked=int(clean.sum()), steps=b * new,
                routing_decisions_that_differ=flips,
                argmax_agreement=float((steps.argmax(-1) == full.argmax(-1))
                                       .float().mean()),
                passed=within)


def _generate_phase(torch, model, plen, new, seed, tag, chunk=None,
                    check_model=None, check_rel=LOGIT_REL):
    """Greedy decode of seeded prompts (b = 2), timed (router decisions
    recorded under MoE), checked against ``generate()`` and by
    :func:`_logits_check`, then a sampled run; with ``chunk``,
    ``generate(prefill_chunk=chunk)`` too.  ``check_model``, a function
    building a model to check, moves the logits gate onto a decode of
    what it builds."""
    from apex_tpu_torch.models import generate, init_cache
    from apex_tpu_torch.ops import prng_key

    cfg = model.cfg
    dev = model.device
    b = 2
    ids = torch.randint(0, cfg.vocab_size, (b, plen), dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    cache = init_cache(model, b)
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("key", "value"))
    del cache
    dense_bytes = (2 * cfg.num_layers * b * cfg.max_seq_len * cfg.kv_heads
                   * cfg.head_dim * 2)
    _decode_run(torch, model, ids, 2)           # first calls, not timed
    torch.cuda.reset_peak_memory_stats()
    with _Routes(torch, model) as routes:
        toks, steps, ttft, dec, prefill, launches = _decode_run(
            torch, model, ids, new)
    peak = torch.cuda.max_memory_allocated()
    gen = generate(model, ids, max_new_tokens=new)
    logits = _logits_check(torch, model, ids, toks, steps, routes, LOGIT_REL)
    st = dict(ttft_s=ttft, decode_tokens_per_s=b * (new - 1) / dec,
              decode_ms_per_step=dec / (new - 1) * 1e3, peak_bytes=peak,
              kv_cache_bytes=kv_bytes, dense_cache_bytes=dense_bytes,
              generate_equals_loop=bool(torch.equal(
                  gen, torch.cat([ids, toks], dim=1))),
              logits_vs_full_forward=logits,
              prefill_launches=prefill, launches=launches)
    ok = gate(f"{tag}: generate() equals the decode loop",
              st["generate_equals_loop"])
    if check_model is None:
        ok &= gate(f"{tag}: step logits vs the full forward",
                   logits["passed"])
    else:
        twin = check_model()
        with _Routes(torch, twin) as twin_routes:
            t_toks, t_steps = _decode_run(torch, twin, ids, new)[:2]
        st["logits_vs_full_forward_check_model"] = _logits_check(
            torch, twin, ids, t_toks, t_steps, twin_routes, check_rel)
        ok &= gate(f"{tag}: the check model's step logits vs its full "
                   "forward", st["logits_vs_full_forward_check_model"][
                       "passed"])
        del twin
        torch.cuda.empty_cache()
    if chunk:
        chunked = generate(model, ids, max_new_tokens=new,
                           prefill_chunk=chunk)
        parted = _first_flip(torch, toks, chunked[:, plen:], steps)
        st["chunked_prefill"] = dict(chunk=chunk, tokens_equal=not parted,
                                     first_flips=parted)
        ok &= gate(f"{tag}: chunked prefill parts only at near ties",
                   all(f["near_tie"] for f in parted))
    sampled = generate(model, ids, max_new_tokens=new, temperature=0.8,
                       top_k=50, top_p=0.95, rng=prng_key(7, dev))
    st["sampled_prompt_kept"] = bool(torch.equal(sampled[:, :plen], ids))
    st["sampled_in_vocab"] = bool(((sampled >= 0)
                                   & (sampled < cfg.vocab_size)).all())
    ok &= gate(f"{tag}: sampled run keeps the prompt, tokens in vocab",
               st["sampled_prompt_kept"] and st["sampled_in_vocab"])
    ok &= gate(f"{tag}: LayerNorm and RoPE kernels launched",
               launches.get("layer_norm", 0) > 0
               and launches.get("rope", 0) > 0)
    log(f"  {tag}: {json.dumps({k: v for k, v in st.items() if 'launches' not in k})}")
    log(f"  {tag} launches: prefill {json.dumps(prefill)}, whole run "
        f"{json.dumps(launches)}")
    return ok, st, ids


def phase_mistral(torch, new=64):
    """Mistral-7B at its published widths and 32 layers, bf16, seeded
    random weights: b = 2 prompts of 6144 tokens prefilled in one call
    (4096 rows through the ring's blocked path, 2048 through the banded
    flash forward), 64 greedy tokens and a sampled run.  Gates: each
    step's logits within 0.05 of the largest entry of a full-sequence
    windowed forward over the same ids; ``prefill_chunk=2048`` gives the
    same tokens or parts only at a near tie (counted); the ring holds
    32·2·4096·8·128·2·2 B; the banded kernel at the ring's shape against
    its plain version; 32 flash-forward launches in the prefill."""
    from apex_tpu_torch.models import LlamaConfig, LlamaModel
    from apex_tpu_torch.ops import attention as A

    log("phase 21: Mistral-7B generate (32 layers, bf16, window 4096, "
        "b=2, 6144-token prompts, 64 new tokens)")
    dev = torch.device("cuda")
    cfg = LlamaConfig.mistral_7b(dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = LlamaModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(21))
    torch.cuda.synchronize()
    log(f"  Mistral-7B weights: {sum(q.numel() for q in model.parameters())}"
        f" params in {time.monotonic() - t0:.1f}s")
    ok, st, _ = _generate_phase(torch, model, 6144, new, 22, "mistral",
                                chunk=2048)
    ring = 32 * 2 * 4096 * 8 * 128 * 2 * 2
    ok &= gate("ring cache bytes", st["kv_cache_bytes"] == ring
               and st["dense_cache_bytes"] == 2 * ring)
    ok &= gate("32 flash-forward launches in the prefill",
               st["prefill_launches"].get("flash_attention_fwd", 0) == 32)
    # the ring chunk path's banded forward at its own shape
    g = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn(2, 2048, 32, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, 6144, 8, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    args = (None, 128 ** -0.5, True, 4096, 0.0, 0)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    o2, lse2 = A.flash_fwd_reference(q, k, v, *args)
    e_o, p_o = _close_rel(torch, o, o2, 2 ** -7)
    e_l, p_l = _close_rel(torch, lse, lse2, 1e-5)
    st["ring_banded_kernel"] = dict(shape=[2, 2048, 6144, 32, 8, 128],
                                    max_abs_err=max(e_o, e_l),
                                    tol="2^-7 (o), 1e-5 (lse) x max |ref|",
                                    passed=p_o and p_l)
    log(f"  ring banded kernel: {json.dumps(st['ring_banded_kernel'])}")
    ok &= gate("ring banded kernel vs its plain version", p_o and p_l)
    del model, q, k, v, o, o2, lse, lse2
    torch.cuda.empty_cache()
    return ok, st


def phase_mixtral(torch, new=32, layers=8):
    """Mixtral-8x7B at its published widths with the depth cut to 8 of
    32 layers (all 32 hold ~93 GB of bf16 weights, more than the card's
    80 GB), bf16, seeded random weights, the drop-free capacity
    (cf = E/k = 4): b = 2 prompts of 1024 tokens, 32 greedy tokens and a
    sampled run, timed in bf16; the logits checked as in phase 21 on a
    twin computing in fp32 with the same bf16 weights (within 1e-3 of
    the largest entry; in bf16 the router's near ties flip between the
    decode and the full forward, which the bf16 check counts), and
    ``moe_aux_loss`` of one forward finite.  Then a tiny MoE model's amp O2 step (bf16
    parameters over fp32 compute, as phase 16's step) on the card
    against the CPU."""
    import dataclasses

    from apex_tpu_torch.models import LlamaConfig, LlamaModel, moe_aux_loss

    log(f"phase 22: Mixtral-8x7B generate ({layers} of 32 layers, bf16, "
        f"b=2, 1024-token prompts, {new} new tokens)")
    dev = torch.device("cuda")
    cfg = LlamaConfig.mixtral_8x7b(num_layers=layers, dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = LlamaModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(31))
    torch.cuda.synchronize()
    log(f"  Mixtral weights ({layers} layers): "
        f"{sum(q.numel() for q in model.parameters())} params in "
        f"{time.monotonic() - t0:.1f}s")
    def twin():
        # the same weights computing in fp32: bf16 noise flips near ties
        # of the router between the decode and the full forward (a flip
        # changes the rest of its row), fp32 noise almost never does
        m = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32),
                       device=dev)
        m.load_state_dict(model.state_dict())
        return m
    ok, st, ids = _generate_phase(torch, model, 1024, new, 32, "mixtral",
                                  check_model=twin, check_rel=1e-3)
    with torch.no_grad():
        model(ids)
        aux = moe_aux_loss(model)
    st["moe_aux_loss"] = float(aux)
    ok &= gate("moe_aux_loss finite and positive",
               bool(torch.isfinite(aux)) and float(aux) > 0)
    st["capacity_factor"] = cfg.moe_capacity_factor
    del model
    torch.cuda.empty_cache()
    good, st["tiny_o2_identity"] = _tiny_o2_identity(torch, "moe")
    return ok and good, st


# ------------------------------------------------------------------ #
# O2 step identity, card against CPU
# ------------------------------------------------------------------ #
TINY_MOE = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, ffn_hidden_size=128, max_seq_len=64,
                sliding_window=16, num_moe_experts=4, moe_top_k=2,
                moe_capacity_factor=1.25)


def _o2_step(torch, cfg, sd, data, dev):
    """One amp O2 step (bf16 parameters, fp32 masters, fp32 compute) of
    the tiny MoE decoder + FusedAdam or ViT-tiny + FusedLAMB on ``dev``:
    loss, logits, the gradients (stored bf16), the masters' change, and
    the two experts each token was routed to (MoE)."""
    import torch.nn.functional as F

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (
        LlamaModel,
        ViTConfig,
        ViTModel,
        moe_aux_loss,
    )
    from apex_tpu_torch.optim import fused_adam, fused_lamb

    vit = isinstance(cfg, ViTConfig)
    model = (ViTModel if vit else LlamaModel)(cfg, device=dev)
    model.load_state_dict(sd)
    state = amp.initialize(model, fused_lamb(1e-3) if vit
                           else fused_adam(1e-3), "O2",
                           half_dtype=torch.bfloat16)
    x, y = (t.to(dev) for t in data)
    routes = []
    hooks = [layer.moe_mlp.register_forward_hook(
        lambda m, i, o: routes.append(torch.einsum(
            "gsh,he->gse", i[0].float(), m.gate.float()).argsort(
                -1, descending=True)[..., :2].cpu()))
        for layer in model.modules() if hasattr(layer, "moe_mlp")]
    logits = model(x)
    for hk in hooks:
        hk.remove()
    if vit:
        loss = F.cross_entropy(logits.float(), y.long())
    else:
        loss = F.cross_entropy(logits.float().flatten(0, 1),
                               y.flatten().long()) + moe_aux_loss(model)
    state.scale_loss(loss).backward()
    grads = {n: q.grad.detach().float().cpu()
             for n, q in model.named_parameters()}
    before = {n: v.detach().clone().cpu() for n, v in state.params.items()}
    finite = bool(state.apply_gradients())
    change = {n: state.params[n].detach().cpu() - v
              for n, v in before.items()}
    return dict(loss=loss.item(), logits=logits.detach().float().cpu(),
                grads=grads, change=change, routes=routes, finite=finite)


def _tiny_o2_identity(torch, kind):
    """Card against CPU for one O2 step: loss and logits within phase
    16's 1e-4 of the largest entry; each gradient (stored bf16) within
    one bf16 ulp of its element or 1e-4 of the largest entry; for the
    MoE, routing decisions that differ are counted (a flip moves whole
    expert gradients, so the gradient gate then stands aside, as phase
    16's does for ReLU flips).  The masters' change is reported, not
    gated: Adam and LAMB normalise the update, so a gradient entry at
    noise level (inside the 1e-4 clause) moves its parameter by up to the
    learning rate either way; phases 12 and 18 hold the optimizers on
    the card to the CPU's on the same gradients."""
    from apex_tpu_torch.models import LlamaConfig, LlamaModel, ViTConfig, ViTModel

    rel = 1e-4
    gen = torch.Generator().manual_seed(41)
    if kind == "moe":
        cfg = LlamaConfig(**TINY_MOE)
        ref = LlamaModel(cfg, device="cpu")
        x = torch.randint(0, 256, (2, 48), generator=gen, dtype=torch.int32)
        data = (x, torch.roll(x, -1, dims=1))
    else:
        cfg = ViTConfig.tiny()
        ref = ViTModel(cfg, device="cpu")
        data = (torch.randn(4, 32, 32, 3, generator=gen),
                torch.randint(0, 10, (4,), generator=gen))
    ref.init_weights(gen)
    sd = ref.state_dict()
    g = _o2_step(torch, cfg, sd, data, torch.device("cuda"))
    c = _o2_step(torch, cfg, sd, data, "cpu")

    def worst(a, b):
        """(worst name, its max |err|, all within): each element within
        one bf16 ulp of the reference element (2^-7 of it at the bottom
        of its binade: the gradients are stored bf16, each device rounds
        its fp32 sum once) or ``rel`` of the tensor's largest entry."""
        errs = {}
        for n, v in b.items():
            d = (a[n] - v).abs()
            bound = torch.clamp(2 ** -7 * v.abs(),
                                min=rel * max(float(v.abs().max()), 1e-30))
            errs[n] = (float((d / bound).max()), float(d.max()))
        name = max(errs, key=lambda n: errs[n][0])
        return name, errs[name][1], errs[name][0] <= 1.0, errs[name][0]
    flips = sum(int((a != b).any(-1).sum()) for a, b in
                zip(g["routes"], c["routes"]))
    gw, ge, g_ok, g_frac = worst(g["grads"], c["grads"])
    cw, ce, c_ok, _ = worst(g["change"], c["change"])
    st = dict(loss_cuda=g["loss"], loss_cpu=c["loss"],
              loss_rel_err=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
              logits_rel_err=float((g["logits"] - c["logits"]).abs().max()
                                   / c["logits"].abs().max()),
              routing_decisions_that_differ=flips,
              grads_within=g_ok, worst_grad=gw, worst_grad_abs_err=ge,
              worst_grad_share_of_tolerance=g_frac,
              changes_within=c_ok, worst_change=cw,
              worst_change_abs_err=ce,
              tolerance=f"loss, logits {rel} of the largest entry; grads "
                        f"one bf16 ulp of the element or {rel} of the "
                        "largest entry, where no routing decision "
                        "differs; changes reported")
    ok = gate(f"{kind} O2 identity: finite steps", g["finite"]
              and c["finite"])
    ok &= gate(f"{kind} O2 identity: loss and logits within {rel}",
               st["loss_rel_err"] <= rel and st["logits_rel_err"] <= rel)
    ok &= gate(f"{kind} O2 identity: gradients", flips > 0 or g_ok)
    log(f"  {kind} O2 identity: {json.dumps(st)}")
    return ok, st


# ------------------------------------------------------------------ #
# phase 23: ViT-Huge amp O2 + FusedLAMB
# ------------------------------------------------------------------ #
VIT_LAUNCHES = {"layer_norm": 129, "layer_norm_bwd": 65,
                "flash_attention_fwd": 64, "flash_attention_bwd_dq": 32,
                "flash_attention_bwd_dkv": 32}


def phase_vit(torch, steps=10, warmup=3, b=32):
    """``bench_configs.py``'s ViT-Huge row: ViT-H/14 at 224x224 (257
    tokens, head dim 80), amp O2 (bf16, fp32 masters), FusedLAMB(1e-3),
    remat, b = 32 on one seeded batch: 3 warm-up and 10 timed steps with
    samples/s, host ms a step, the fwd/bwd/opt split and peak memory;
    every timed loss must lie below the loss at initialisation and each
    step launch the LayerNorm and flash kernels
    ``VIT_LAUNCHES`` times (32 layers, recomputed once).  The step's
    attention device ms: each flash kernel's ms a call at the step's
    shape (b, 257, 16 heads, d 80, bf16; CUDA events, enqueue hidden)
    times its launches a step, with the route each took (all three must
    be ``wgmma``).  Then ViT-tiny's
    O2 + FusedLAMB step on the card against the CPU."""
    import torch.nn.functional as F

    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import ViTConfig, ViTModel
    from apex_tpu_torch.optim import fused_lamb

    log(f"phase 23: ViT-Huge amp O2 + FusedLAMB, b={b} at 224x224, remat")
    dev = torch.device("cuda")
    cfg = ViTConfig.vit_huge(dtype=torch.bfloat16, remat=True)
    model = ViTModel(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(51)
    model.init_weights(g)
    state = amp.initialize(model, fused_lamb(1e-3), "O2",
                           half_dtype=torch.bfloat16)
    x = torch.randn(b, 224, 224, 3, generator=g, device=dev)
    y = torch.randint(0, cfg.num_classes, (b,), generator=g, device=dev)

    def loss_of():
        return F.cross_entropy(model(x).float(), y)

    def train_step():
        loss = loss_of()
        state.scale_loss(loss).backward()
        finite = state.apply_gradients()
        return loss.detach(), finite

    def fwd_only():
        with torch.no_grad():
            return loss_of()

    def fwd_bwd():
        loss = loss_of()
        state.scale_loss(loss).backward()
        for q in model.parameters():
            q.grad = None
        return loss.detach()

    warm_losses = [float(train_step()[0]) for _ in range(warmup)]
    t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
    t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, outs, host_ms = _event_times(torch, train_step, steps)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(o[0]) for o in outs]
    finite = [bool(o[1]) for o in outs]
    t_step = sum(step_ms) / len(step_ms)
    per_step = {k: v / steps for k, v in launches.items()}
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    fb_peak = torch.cuda.max_memory_allocated()
    attn = _vit_attention_ms(torch, b, cfg, per_step)
    stats = dict(
        samples_per_s=b * steps / (sum(step_ms) / 1e3), step_ms=step_ms,
        host_ms_per_step=sum(host_ms) / len(host_ms), fwd_ms=t_fwd,
        bwd_ms=max(t_fb - t_fwd, 0.0), opt_ms=max(t_step - t_fb, 0.0),
        peak_bytes=peak, fwd_bwd_peak_bytes=fb_peak,
        loss_init=warm_losses[0], warmup_losses=warm_losses, losses=losses,
        finite=finite,
        params=sum(q.numel() for q in model.parameters()),
        attention_ms_by_launches=attn,
        launches_per_step=per_step, launches=launches)
    log(f"  {json.dumps({k: v for k, v in stats.items() if k != 'launches'})}")
    # one batch under LAMB(1e-3) without warm-up: the loss drops from
    # ln(1000) towards 1e-3 and spikes back between steps (on the card:
    # 0.70 after three updates, 0.0005, then 0.35 at the last timed
    # step), so two timed steps compare at random points of the spikes;
    # the gate is that every timed loss is below the loss at
    # initialisation, as phases 8, 15 and 17 hold theirs to it
    ok = gate("ViT-Huge: finite steps, every timed loss below the loss "
              "at initialisation",
              all(finite) and all(np.isfinite(warm_losses + losses))
              and all(x < warm_losses[0] for x in losses))
    for name, want in VIT_LAUNCHES.items():
        if per_step.get(name) != want:
            log(f"  launches of {name}: {per_step.get(name)} per step, "
                f"expected {want}")
            ok = False
    routes = {k: v["route"] for k, v in attn.items() if isinstance(v, dict)}
    ok &= gate(f"ViT-Huge: every flash kernel on the wgmma route {routes}",
               set(routes.values()) == {"wgmma"})
    del model, state, outs, x
    torch.cuda.empty_cache()
    good, stats["tiny_o2_identity"] = _tiny_o2_identity(torch, "vit")
    return ok and good, stats


# ------------------------------------------------------------------ #
# phases 24, 25: the parallel slice on a world of one (NCCL)
# ------------------------------------------------------------------ #
# GPT-2 1.3B with remat: two LayerNorms a layer and the final one each
# forward, the layers' recomputed once; one flash forward a layer and its
# recomputation
GPT_LAUNCHES = {"layer_norm": 97, "layer_norm_bwd": 49,
                "flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                "flash_attention_bwd_dkv": 24}
GPT_GROUPS = {"flash_fwd": r"fa_fwd_", "flash_dq": r"fa_bwd_dq_",
              "flash_dkv": r"fa_bwd_dkv_", "layer_norm": r"ln_fwd_",
              "layer_norm_bwd": r"ln_bwd_dx", "nccl": r"(?i)nccl",
              "gemms": r"nvjet|gemm|cutlass"}


def _world_of_one(torch):
    """A world-of-one NCCL group (``init_distributed``, no environment:
    a file store) and the mesh on it."""
    import torch.distributed as dist

    from apex_tpu_torch.core.mesh import initialize_mesh
    from apex_tpu_torch.parallel.launch import init_distributed

    init_distributed()
    mesh = initialize_mesh(tensor_model_parallel_size=1)
    log(f"  process group: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, mesh {mesh.shape}")
    return dist.get_backend() == "nccl" and dist.get_world_size() == 1


def _flash_lanes_check(torch):
    """The dropout lanes of a tensor-parallel rank's heads on the card:
    the three flash kernels on heads 4..7 of 16 with ``lanes=(16, 4)``
    equal the whole call's heads 4..7 bit for bit (and the plain version
    with the same lanes)."""
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(241)
    b, s, h, d = 2, 384, 16, 128
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    args = (None, d ** -0.5, True, None, 0.1, 777)
    part = slice(4, 8)

    def run(q, k, v, do, lanes, kernel):
        fwd = A.flash_fwd_kernel if kernel else A.flash_fwd_reference
        o, lse = fwd(q, k, v, *args, lanes)
        bw = (q, k, v, None, do, lse, A.attention_delta(do, o), *args[1:],
              lanes)
        dq_fn = A.flash_bwd_dq_kernel if kernel else A.flash_bwd_dq_reference
        dkv_fn = (A.flash_bwd_dkv_kernel if kernel
                  else A.flash_bwd_dkv_reference)
        return (o, dq_fn(*bw), *dkv_fn(*bw))
    whole = run(q, k, v, do, None, True)
    sub = [t[:, :, part].contiguous() for t in (q, k, v, do)]
    mine = run(*sub, (h, 4), True)
    plain = run(*sub, (h, 4), False)
    bitwise = all(torch.equal(a[:, :, part], m) for a, m in zip(whole, mine))
    plain_err = max(float((m.float() - p.float()).abs().max())
                    for m, p in zip(mine, plain))
    log(f"  flash dropout lanes (16 heads, rank's 4..7): kernels equal the "
        f"whole call's heads bitwise {bitwise}; max |kernel - plain| "
        f"{plain_err:.3g}")
    return bitwise and plain_err <= 2 ** -6, dict(
        lanes_bitwise_whole_call=bitwise, lanes_plain_abs_err=plain_err)


def phase_gpt_tp(torch, profile=False, steps=10, warmup=3, b=8, s=1024):
    """GPT-2 1.3B (``apex_tpu/models/gpt.py``'s preset: 24 layers, hidden
    2048, 16 heads of 128, vocab 50304, learned positions) in bf16 with
    remat, amp O2 + FusedAdam with bf16 moments, b = 8 x s = 1024, on the
    parallel path at a world of one: a mesh (tensor axis 1), sequence
    parallelism and ZeRO stage 2 over the data axis, every collective
    called over NCCL.  One step against the same seeded step without a
    mesh and with the plain FusedAdam state: loss, gradients and updated
    masters bitwise.  Then 3 warm-up and 10 timed steps: samples/s,
    tokens/s, host ms, the fwd/bwd/opt split, peak memory, the LayerNorm
    and flash launches a step; the initial loss within 0.8-1.6 ln V and
    the loss falls.  Last, the flash kernels' dropout lanes for a
    tensor-parallel rank's heads (``_flash_lanes_check``).  One more step
    runs under the allocator's history (:func:`_memory_breakdown`)."""
    import dataclasses

    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import GPTConfig, GPTModel, gpt_loss_fn
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel.distributed_optim import ZeroConfig
    from apex_tpu_torch.parallel.launch import destroy_distributed

    log(f"phase 24: GPT-2 1.3B amp O2 on the TP/SP/ZeRO-2 path at a world "
        f"of one (NCCL), b={b} s={s}, remat")
    dev = torch.device("cuda")
    cfg = GPTConfig.gpt2_1p3b(dtype=torch.bfloat16, remat=True,
                              sequence_parallel=True)
    ok, stats = True, {}
    try:
        # the plain twin: built before the mesh, so its layers hold whole
        # weights and call nothing; the same weights for both
        plain = GPTModel(cfg, device=dev)
        plain.init_weights(torch.Generator(device=dev).manual_seed(24))
        sd = plain.state_dict()
        ok &= gate("world of one over NCCL", _world_of_one(torch))
        model = GPTModel(cfg, device=dev)
        model.load_state_dict(sd)
        del sd
        opt = dict(moment_dtype=torch.bfloat16)
        ref = amp.initialize(plain, fused_adam(1e-4, **opt), "O2",
                             half_dtype=torch.bfloat16)
        state = amp.initialize(model, fused_adam(1e-4, **opt), "O2",
                               half_dtype=torch.bfloat16,
                               zero=ZeroConfig(axis="data", stage=2))
        g = torch.Generator(device=dev).manual_seed(25)
        ids = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                            device=dev)
        x, y = ids[:, :-1], ids[:, 1:]

        def loss_of(m):
            return gpt_loss_fn(m(x).float(), y)

        # one step each: loss, gradients, masters bit for bit
        losses0 = []
        for st, m in ((ref, plain), (state, model)):
            loss = loss_of(m)
            st.scale_loss(loss).backward()
            losses0.append(loss.detach())
        same_loss = torch.equal(losses0[0], losses0[1])
        bad_grads = [n for (n, a), (_, q) in zip(plain.named_parameters(),
                                                 model.named_parameters())
                     if not torch.equal(a.grad, q.grad)]
        ref.apply_gradients()
        state.apply_gradients()
        mz, mp = state.master_params(), ref.master_params()
        bad_masters = [n for n in mp if not torch.equal(mp[n], mz[n])]
        bad_params = [n for (n, a), (_, q) in zip(plain.named_parameters(),
                                                  model.named_parameters())
                      if not torch.equal(a, q)]
        ident = dict(loss_plain=float(losses0[0]), loss_mesh=float(losses0[1]),
                     loss_bitwise=same_loss, grads=len(mp),
                     grads_differing=bad_grads[:5],
                     masters_differing=bad_masters[:5],
                     params_differing=bad_params[:5])
        log(f"  one step, mesh + SP + ZeRO-2 against plain: "
            f"{json.dumps(ident)}")
        ok &= gate("GPT-2 1.3B: loss, gradients, masters and params of the "
                   "parallel step bitwise equal to the plain step",
                   same_loss and not bad_grads and not bad_masters
                   and not bad_params)
        stats["identity"] = ident
        del mz, mp

        def plain_step():
            loss = loss_of(plain)
            ref.scale_loss(loss).backward()
            ref.apply_gradients()
            return loss.detach()
        # the plain twin's own steps, for what the parallel path costs
        plain_ms, _, plain_host = _event_times(torch, plain_step, 4)
        stats.update(plain_step_ms=plain_ms, plain_host_ms=plain_host)
        log(f"  plain steps (no mesh, plain FusedAdam): ms {plain_ms}, "
            f"host ms {plain_host}")
        del ref, plain
        torch.cuda.empty_cache()
        loss_init = float(losses0[0])
        ln_v = math.log(cfg.vocab_size)
        ok &= gate(f"GPT-2 1.3B: initial loss {loss_init:.4f} within "
                   f"0.8-1.6 ln V ({ln_v:.4f})",
                   0.8 * ln_v <= loss_init <= 1.6 * ln_v)

        def train_step():
            loss = loss_of(model)
            state.scale_loss(loss).backward()
            finite = state.apply_gradients()
            return loss.detach(), finite

        def fwd_only():
            with torch.no_grad():
                return loss_of(model)

        def fwd_bwd():
            loss = loss_of(model)
            state.scale_loss(loss).backward()
            for q in model.parameters():
                q.grad = None
            return loss.detach()

        warm_losses = [float(train_step()[0]) for _ in range(warmup)]
        t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
        t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        step_ms, outs, host_ms = _event_times(torch, train_step, steps)
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(o[0]) for o in outs]
        finite = [bool(o[1]) for o in outs]
        t_step = sum(step_ms) / len(step_ms)
        per_step = {k: v / steps for k, v in launches.items()}
        prof = (_profile_train(torch, train_step, groups=GPT_GROUPS)
                if profile else None)
        stats.update(
            samples_per_s=b * steps / (sum(step_ms) / 1e3),
            tokens_per_s=b * s * steps / (sum(step_ms) / 1e3),
            step_ms=step_ms, host_ms_per_step=sum(host_ms) / len(host_ms),
            fwd_ms=t_fwd, bwd_ms=max(t_fb - t_fwd, 0.0),
            opt_ms=max(t_step - t_fb, 0.0), peak_bytes=peak,
            loss_init=loss_init, warmup_losses=warm_losses, losses=losses,
            finite=finite, params=sum(q.numel() for q in model.parameters()),
            launches_per_step=per_step, launches=launches)
        log(f"  {json.dumps({k: v for k, v in stats.items() if k not in ('launches', 'identity')})}")
        if prof is not None:
            stats["profile"] = prof
            log(f"  profile: {json.dumps(prof)}")
        ok &= gate("GPT-2 1.3B: finite steps and the loss falls",
                   all(finite) and all(np.isfinite(warm_losses + losses))
                   and losses[-1] < loss_init)
        for name, want in GPT_LAUNCHES.items():
            ok &= gate(f"launches of {name}: {per_step.get(name)} a step, "
                       f"expected {want}", per_step.get(name) == want)
        stats["memory_breakdown"] = _memory_breakdown(
            torch, train_step, {"model": model, "train state": state})
        log(f"  memory breakdown: {json.dumps(stats['memory_breakdown'])}")
        del model, state, outs
        torch.cuda.empty_cache()
        good, stats["flash_lanes"] = _flash_lanes_check(torch)
        ok &= gate("flash dropout lanes of a rank's heads", good)
    finally:
        destroy_distributed()
    return ok, stats


def phase_resnet_ddp(torch, profile=False, steps=10, warmup=3, b=128,
                     size=224):
    """ResNet-50 (phase 15's: bf16 compute copy, fused BN, s2d stem) amp
    O1 + FusedSGD at b = 128 on 224x224, with every BN converted to the
    data group's statistics (``convert_syncbn_model``) and the gradients
    averaged by ``DistributedDataParallel.mean_grads`` each step, at a
    world of one over NCCL.  One step (cuDNN deterministic) against the
    same seeded step of the local-BN model without DDP: loss, gradients,
    parameters and running statistics bitwise.  Then 3 warm-up and 10
    timed steps (samples/s, host ms, the split, peak memory; each BN
    kernel 53 launches a step; the loss falls below its value at
    initialisation), and one step over the int8 all-reduce (a quantize
    round trip at one rank: finite, not bitwise)."""
    import torch.nn.functional as F

    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import resnet50
    from apex_tpu_torch.optim import fused_sgd
    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        convert_syncbn_model,
    )
    from apex_tpu_torch.parallel.launch import destroy_distributed

    log(f"phase 25: ResNet-50 amp O1 + DDP + SyncBatchNorm at a world of "
        f"one (NCCL), b={b}, {size}x{size}")
    dev = torch.device("cuda")
    bench_was = torch.backends.cudnn.benchmark
    det_was = torch.backends.cudnn.deterministic
    ok, stats = True, {}
    try:
        ok &= gate("world of one over NCCL", _world_of_one(torch))
        local = resnet50(dtype=torch.bfloat16, fused_bn=True, stem="s2d")
        local.init_weights(torch.Generator(device=dev).manual_seed(9))
        model = resnet50(dtype=torch.bfloat16, fused_bn=True, stem="s2d")
        model.load_state_dict(local.state_dict())
        convert_syncbn_model(model, ("data",))
        ddp = DistributedDataParallel()
        ddp.replicate(model)

        def sgd():
            return fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)
        ref = amp.initialize(local, sgd(), "O1")
        state = amp.initialize(model, sgd(), "O1")
        g = torch.Generator(device=dev).manual_seed(10)
        images = torch.randn(b, size, size, 3, generator=g, device=dev)
        labels = torch.randint(0, 1000, (b,), generator=g, device=dev)
        onehot = F.one_hot(labels, 1000).float()
        images, onehot = ddp.shard((images, onehot))

        def loss_of(m):
            return _resnet_loss(torch, m(images), onehot)

        def ddp_step(d=ddp):
            loss = loss_of(model)
            state.scale_loss(loss).backward()
            grads = d.mean_grads([q.grad for q in state.module_params])
            finite = state.apply_gradients(grads)
            for q in state.module_params:
                q.grad = None
            return loss.detach(), finite

        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        loss_r = loss_of(local)
        ref.scale_loss(loss_r).backward()
        grads_r = {n: q.grad.clone() for n, q in local.named_parameters()}
        ref.apply_gradients()
        loss_m = loss_of(model)
        state.scale_loss(loss_m).backward()
        grads_m = ddp.mean_grads({n: q.grad for n, q in
                                  model.named_parameters()})
        state.apply_gradients([grads_m[n] for n in state.names])
        bad = dict(
            grads=[n for n in grads_r if not torch.equal(grads_r[n],
                                                         grads_m[n])],
            params=[n for (n, a), (_, q) in zip(local.named_parameters(),
                                                model.named_parameters())
                    if not torch.equal(a, q)],
            stats=[n for (n, a), (_, q) in zip(local.named_buffers(),
                                               model.named_buffers())
                   if not torch.equal(a, q)])
        ident = dict(loss_local=float(loss_r.detach()),
                     loss_ddp=float(loss_m.detach()),
                     loss_bitwise=torch.equal(loss_r, loss_m),
                     **{f"{k}_differing": v[:5] for k, v in bad.items()})
        log(f"  one step, SyncBN + DDP against local BN: {json.dumps(ident)}")
        ok &= gate("ResNet-50: loss, gradients, parameters and running "
                   "statistics of the DDP + SyncBN step bitwise equal to "
                   "the local step", ident["loss_bitwise"]
                   and not any(bad.values()))
        stats["identity"] = ident
        del grads_r, grads_m
        torch.backends.cudnn.deterministic = det_was
        torch.backends.cudnn.benchmark = True

        def local_step():
            loss = loss_of(local)
            ref.scale_loss(loss).backward()
            ref.apply_gradients()
            return loss.detach()
        # the local model's own steps (no SyncBN, no DDP), for what the
        # parallel path costs
        for _ in range(warmup):
            local_step()
        local_ms, _, local_host = _event_times(torch, local_step, 5)
        stats.update(local_step_ms=local_ms, local_host_ms=local_host)
        log(f"  local steps (local BN, no DDP): ms {local_ms}, host ms "
            f"{local_host}")
        del ref, local
        torch.cuda.empty_cache()
        loss_init = float(loss_m.detach())

        def fwd_only():
            with torch.no_grad():
                return loss_of(model)

        def fwd_bwd():
            loss = loss_of(model)
            state.scale_loss(loss).backward()
            ddp.mean_grads([q.grad for q in state.module_params])
            for q in state.module_params:
                q.grad = None
            return loss.detach()

        warm_losses = [float(ddp_step()[0]) for _ in range(warmup)]
        t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
        t_fb = sorted(_event_times(torch, fwd_bwd, 5)[0])[2]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        step_ms, outs, host_ms = _event_times(torch, ddp_step, steps)
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(o[0]) for o in outs]
        finite = [bool(o[1]) for o in outs]
        t_step = sum(step_ms) / len(step_ms)
        per_step = {k: launches.get(k, 0) / steps for k in BN_KERNELS}
        prof = (_profile_train(torch, ddp_step, groups=dict(
            RESNET_GROUPS, nccl=r"(?i)nccl")) if profile else None)
        int8 = DistributedDataParallel(allreduce_dtype="int8")
        l8, f8 = ddp_step(int8)
        int8_ok = (bool(f8) and math.isfinite(float(l8)) and all(
            bool(torch.isfinite(q).all()) for q in model.parameters()))
        stats.update(
            samples_per_s=b * steps / (sum(step_ms) / 1e3), step_ms=step_ms,
            host_ms_per_step=sum(host_ms) / len(host_ms), fwd_ms=t_fwd,
            bwd_ms=max(t_fb - t_fwd, 0.0), opt_ms=max(t_step - t_fb, 0.0),
            peak_bytes=peak, loss_init=loss_init, warmup_losses=warm_losses,
            losses=losses, finite=finite, int8_step_loss=float(l8),
            int8_step_finite=int8_ok, launches_per_step=per_step,
            launches=launches)
        log(f"  {json.dumps({k: v for k, v in stats.items() if k not in ('launches', 'identity')})}")
        if prof is not None:
            stats["profile"] = prof
            log(f"  profile: {json.dumps(prof)}")
        ok &= gate("ResNet-50 DDP: finite steps, the loss below its value "
                   "at initialisation",
                   all(finite) and all(np.isfinite(warm_losses + losses))
                   and min(warm_losses + losses) < loss_init)
        ok &= gate("ResNet-50 DDP: one int8 all-reduce step, finite", int8_ok)
        for name in BN_KERNELS:
            ok &= gate(f"launches of {name}: {per_step[name]} a step, "
                       f"expected {RESNET_BN_LAUNCHES}",
                       per_step[name] == RESNET_BN_LAUNCHES)
        del model, state, outs, images
    finally:
        torch.backends.cudnn.benchmark = bench_was
        torch.backends.cudnn.deterministic = det_was
        destroy_distributed()
        torch.cuda.empty_cache()
    return ok, stats



# ------------------------------------------------------------------ #
# where a training step's memory goes (phases 24 and 26)
# ------------------------------------------------------------------ #
def _repo_line(frames):
    """``file:line (function)`` of the innermost frame of the port or of
    this script in an allocation's Python stack (innermost first)."""
    for f in frames:
        name = f.get("filename", "")
        if "apex_tpu_torch" in name or name.endswith("chip_smoke.py"):
            tail = name[name.find("apex_tpu_torch"):] if (
                "apex_tpu_torch" in name) else "chip_smoke.py"
            return f"{tail}:{f.get('line')} ({f.get('name')})"
    return "elsewhere"


def _live_tensors(torch, owners):
    """Bytes of the CUDA tensors the Python heap holds, each storage
    once: by owner (``owners``: name -> object whose tensors, reached
    through attributes, containers and module parameters, count as its
    own) and the largest others by shape and dtype."""
    import gc

    def ptrs(obj, seen, depth=0):
        if id(obj) in seen or depth > 6:
            return
        seen.add(id(obj))
        if torch.is_tensor(obj):
            if obj.is_cuda:
                yield obj.untyped_storage().data_ptr()
            if isinstance(obj, torch.nn.Parameter) and obj.grad is not None:
                yield from ptrs(obj.grad, seen, depth + 1)
            return
        if isinstance(obj, torch.nn.Module):
            for t in list(obj.parameters()) + list(obj.buffers()):
                yield from ptrs(t, seen, depth + 1)
            return
        if isinstance(obj, dict):
            items = obj.values()
        elif isinstance(obj, (list, tuple, set)):
            items = obj
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            items = vars(obj).values()
        else:
            return
        for v in list(items):
            yield from ptrs(v, seen, depth + 1)

    sizes = {}
    for o in gc.get_objects():
        try:
            if torch.is_tensor(o) and o.is_cuda:
                st = o.untyped_storage()
                sizes.setdefault(st.data_ptr(), (st.nbytes(), tuple(o.shape),
                                                 str(o.dtype)))
        except Exception:       # a half-made object: not a tensor of ours
            continue
    out, claimed = {}, set()
    for name, obj in owners.items():
        mine = set(ptrs(obj, set())) - claimed
        claimed |= mine
        out[name] = sum(sizes[p][0] for p in mine if p in sizes)
    others = {}
    for p, (n, shape, dt) in sizes.items():
        if p not in claimed:
            key = f"{shape} {dt}"
            others[key] = others.get(key, 0) + n
    out["other"] = sum(others.values())
    out["largest_other"] = dict(sorted(others.items(),
                                       key=lambda kv: -kv[1])[:8])
    out["python_total"] = sum(n for n, _, _ in sizes.values())
    return out


def _memory_breakdown(torch, step, owners):
    """One ``step()`` under the CUDA allocator's history: the bytes
    alive before it (the Python-held CUDA tensors by owner,
    :func:`_live_tensors`, and what the allocator holds beyond them),
    and the peak within it, the bytes the step allocated that are alive
    at that peak grouped by the allocating line of the port or of this
    script (:func:`_repo_line`)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held = _live_tensors(torch, owners)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        step()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    trace = snap["device_traces"][torch.cuda.current_device()]
    cur, best, at = 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] == "free_completed":
            cur -= e["size"]
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _repo_line(e.get("frames", [])))
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    by_line = {}
    for n, line in live.values():
        by_line[line] = by_line.get(line, 0) + n
    return dict(
        alive_before=before, held_before=held,
        held_by_cpp_only=before - held["python_total"], peak=peak,
        step_peak_above_before=best, trace_events=len(trace),
        peak_by_line=dict(sorted(by_line.items(),
                                 key=lambda kv: -kv[1])[:12]))


# ------------------------------------------------------------------ #
# phase 26: pipeline parallelism on a world of one (NCCL)
# ------------------------------------------------------------------ #
def _gpt_pipeline_model(torch, cfg, sd, dev):
    """GPT-2 1.3B cut for the pipeline: the closure (a ``GPTModel`` of
    no layers with an untied head: embedding, positions, final norm,
    head) and this rank's stage from ``build_model``, loaded from the
    whole model's state dict ``sd`` (the head a copy of the tied table,
    so the forward is the whole model's).  Returns ``(model, stage_fn)``,
    the model holding ``closure`` and ``stages``."""
    import dataclasses
    import functools

    import torch.nn as nn

    from apex_tpu_torch.core.mesh import get_mesh
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.transformer import ParallelTransformerLayer
    from apex_tpu_torch.parallel import pipeline as pl
    from apex_tpu_torch.transformer.pipeline_parallel import build_model

    pp = get_mesh().shape["pipe"]
    stage_fn, chunks = build_model(
        functools.partial(ParallelTransformerLayer, cfg), cfg.num_layers, pp,
        device=dev, layer_remat=True)
    model = nn.Module()
    model.closure = GPTModel(dataclasses.replace(
        cfg, num_layers=0, tie_embeddings=False), device=dev)
    model.stages = chunks[0]
    pre = "transformer.layers."
    model.stages.load_state_dict(pl.local_stage(pl.stage_split(
        {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}, pp)))
    model.closure.load_state_dict(
        {k: v for k, v in sd.items() if not k.startswith(pre)}
        | {"lm_head.weight": sd["embedding.weight"]})
    return model, stage_fn


def phase_gpt_pipeline(torch, profile=False, steps=10, warmup=3, b=8,
                       s=1024, gpt_tp=None):
    """GPT-2 1.3B (phase 24's preset, weights and batch) through the
    pipeline at a world of one over NCCL (pipe 1, data 1, tensor 1):
    bf16 with remat (``build_model(..., layer_remat=True)``), amp O2 +
    FusedAdam (bf16 moments), stage-local ZeRO-2, b = 8 x s = 1024 in
    M = 4 microbatches of 2; embedding, positions, final norm and the
    untied head closed over the pipelined region (``loss_params``, the
    input cotangents); the step is ``wrap_pipeline_step`` over
    ``run_1f1b``, ``sync_grad_overflow`` and ``apply_gradients``.  One
    step bitwise against ``forward_backward_no_pipelining`` over the
    same microbatches and weights (loss, gradients, fp32 masters,
    parameters); the loss within 2e-3 of the whole model's on the same
    batch; the LayerNorm and flash launches a step, four microbatches of
    phase 24's step; 3 warm-up and 10 timed steps (samples/s, tokens/s,
    host ms, the split, peak memory, beside phase 24's numbers
    ``gpt_tp``); the initial loss within 0.8-1.6 ln V and the loss
    falls; the schedule's peak memory (from just before the forwards to
    just before ``apply_gradients``) at M = 8 no more than at M = 4 plus
    the O(M) buffers and 64 MiB, the whole step's peak logged beside it;
    one more step under the allocator's history
    (:func:`_memory_breakdown`)."""
    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.models import (
        GPTConfig,
        GPTModel,
        gpt_loss_fn,
        gpt_pipeline_forward_backward,
    )
    from apex_tpu_torch.optim import fused_adam
    from apex_tpu_torch.parallel import pipeline as pl
    from apex_tpu_torch.parallel.distributed_optim import ZeroConfig
    from apex_tpu_torch.parallel.launch import destroy_distributed
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining,
    )

    torch.cuda.synchronize()
    alive_at_start = torch.cuda.memory_allocated()
    mb = 2
    log(f"phase 26: GPT-2 1.3B amp O2 through the 1F1B pipeline at a world "
        f"of one (NCCL), b={b} s={s} in {b // mb} microbatches of {mb}, "
        f"remat, stage-local ZeRO-2")
    dev = torch.device("cuda")
    cfg = GPTConfig.gpt2_1p3b(dtype=torch.bfloat16, remat=True,
                              sequence_parallel=True)
    adam = dict(moment_dtype=torch.bfloat16)
    ok, stats = True, {}

    def batch(seed, rows):
        g = torch.Generator(device=dev).manual_seed(seed)
        ids = torch.randint(0, cfg.vocab_size, (rows, s + 1), generator=g,
                            device=dev)
        return ids[:, :-1], ids[:, 1:]
    x, y = batch(25, b)
    try:
        # phase 24's weights (fp32, before the O2 cast) and batch, and the
        # whole model's loss on them
        whole = GPTModel(cfg, device=dev)
        whole.init_weights(torch.Generator(device=dev).manual_seed(24))
        sd = {k: v.clone() for k, v in whole.state_dict().items()}
        amp.initialize(whole, fused_adam(1e-4, **adam), "O2",
                       half_dtype=torch.bfloat16)
        with torch.no_grad():
            whole_loss = float(gpt_loss_fn(whole(x).float(), y))
        del whole
        torch.cuda.empty_cache()
        ok &= gate("world of one over NCCL", _world_of_one(torch))

        def make():
            model, stage_fn = _gpt_pipeline_model(torch, cfg, sd, dev)
            state = pl.stage_local_zero(amp.initialize(
                model, fused_adam(1e-4, **adam), "O2",
                half_dtype=torch.bfloat16,
                zero=ZeroConfig(axis="data", stage=2)), num_stages=1)
            return model, stage_fn, state
        model, stage_fn, state = make()
        ref, _, ref_state = make()
        del sd
        cl = model.closure

        def fwd_bwd(ids, labels):
            """The pipelined forward and backward of one batch and the
            pipe-global overflow sync: the mean microbatch loss
            (unscaled) and the scaled one."""
            out = gpt_pipeline_forward_backward(
                cl, stage_fn, model.stages, ids, labels,
                num_microbatches=ids.shape[0] // mb,
                scale_loss=state.scale_loss)
            pl.sync_grad_overflow(model)
            return out

        def body(state, ids, labels):
            loss, _ = fwd_bwd(ids, labels)
            return loss, state.apply_gradients()
        step = pl.wrap_pipeline_step(body, state=state)

        # one step each way, bit for bit: the loss and the gradients,
        # then the fp32 masters and parameters after the update
        loss0, scaled0 = fwd_bwd(x, y)
        ref_ces = []

        def ref_fwd(mod, batch_mb):
            i, lab = batch_mb
            out = stage_fn(mod.stages, mod.closure.embed(i))
            ce = gpt_loss_fn(mod.closure.head(out).float(), lab)
            ref_ces.append(ce.detach())
            return ref_state.scale_loss(ce)
        ref_scaled, ref_grads = forward_backward_no_pipelining(
            ref_fwd, (x, y), ref, num_microbatches=b // mb)
        ref_loss = torch.stack(ref_ces).mean()
        same_loss = (torch.equal(loss0, ref_loss)
                     and torch.equal(scaled0, ref_scaled))
        pairs = list(zip(ref.named_parameters(), model.named_parameters()))
        bad_grads = [n for (n, a), (_, q) in pairs
                     if not torch.equal(a.grad, q.grad)]
        state.apply_gradients()
        ref_state.apply_gradients()
        mz, mp = state.master_params(), ref_state.master_params()
        bad_masters = [n for n in mp if not torch.equal(mp[n], mz[n])]
        bad_params = [n for (n, a), (_, q) in pairs if not torch.equal(a, q)]
        ident = dict(loss_pipeline=float(loss0), loss_no_pipelining=float(
            ref_loss), loss_whole_model=whole_loss,
            loss_phase24=(gpt_tp or {}).get("loss_init"),
            loss_bitwise=same_loss, grads=len(pairs),
            grads_differing=bad_grads[:5], masters_differing=bad_masters[:5],
            params_differing=bad_params[:5])
        stats["identity"] = ident
        log(f"  one step, 1F1B against no pipelining: {json.dumps(ident)}")
        ok &= gate("GPT-2 1.3B pipeline: loss, gradients, masters and "
                   "parameters of the 1F1B step bitwise equal to no "
                   "pipelining's", same_loss and not bad_grads
                   and not bad_masters and not bad_params)
        loss_init = float(loss0)
        ok &= gate(f"GPT-2 1.3B pipeline: loss {loss_init:.5f} within 2e-3 "
                   f"of the whole model's {whole_loss:.5f}",
                   abs(loss_init - whole_loss) <= 2e-3)
        ln_v = math.log(cfg.vocab_size)
        ok &= gate(f"GPT-2 1.3B pipeline: initial loss {loss_init:.4f} "
                   f"within 0.8-1.6 ln V ({ln_v:.4f})",
                   0.8 * ln_v <= loss_init <= 1.6 * ln_v)
        # ref_grads holds the no-pipelining gradients after
        # apply_gradients cleared .grad: gone with the rest of the twin
        del ref, ref_state, ref_grads, mz, mp, pairs
        torch.cuda.empty_cache()

        def train_step():
            return step(x, y)

        def fwd_only():
            with torch.no_grad():
                return torch.stack([gpt_loss_fn(cl.head(stage_fn(
                    model.stages, cl.embed(i))).float(), lab)
                    for i, lab in zip(x.chunk(b // mb), y.chunk(b // mb))])

        def fwd_bwd_only():
            loss, _ = fwd_bwd(x, y)
            for q in model.parameters():
                q.grad = None
            return loss

        warm_losses = [float(train_step()[0]) for _ in range(warmup)]
        t_fwd = sorted(_event_times(torch, fwd_only, 5)[0])[2]
        t_fb = sorted(_event_times(torch, fwd_bwd_only, 5)[0])[2]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        step_ms, outs, host_ms = _event_times(torch, train_step, steps)
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(o[0]) for o in outs]
        finite = [bool(o[1]) for o in outs]
        t_step = sum(step_ms) / len(step_ms)
        per_step = {k: v / steps for k, v in launches.items()}
        prof = (_profile_train(torch, train_step, groups=GPT_GROUPS)
                if profile else None)
        stats.update(
            samples_per_s=b * steps / (sum(step_ms) / 1e3),
            tokens_per_s=b * s * steps / (sum(step_ms) / 1e3),
            step_ms=step_ms, host_ms_per_step=sum(host_ms) / len(host_ms),
            fwd_ms=t_fwd, bwd_ms=max(t_fb - t_fwd, 0.0),
            opt_ms=max(t_step - t_fb, 0.0), peak_bytes=peak,
            loss_init=loss_init, warmup_losses=warm_losses, losses=losses,
            finite=finite, microbatches=b // mb, microbatch_size=mb,
            peak_live=pl.schedules.last_run.get("peak_live"),
            launches_per_step=per_step, launches=launches,
            phase24={k: (gpt_tp or {}).get(k) for k in (
                "samples_per_s", "tokens_per_s", "host_ms_per_step",
                "fwd_ms", "bwd_ms", "opt_ms", "peak_bytes")})
        log(f"  {json.dumps({k: v for k, v in stats.items() if k not in ('launches', 'identity')})}")
        if prof is not None:
            stats["profile"] = prof
            log(f"  profile: {json.dumps(prof)}")
        ok &= gate("GPT-2 1.3B pipeline: finite steps and the loss falls",
                   all(finite) and all(np.isfinite(warm_losses + losses))
                   and losses[-1] < loss_init)
        for name, want in GPT_LAUNCHES.items():
            want = want * (b // mb)
            ok &= gate(f"pipeline launches of {name}: {per_step.get(name)} "
                       f"a step, expected {want}", per_step.get(name) == want)

        # the 1F1B memory shape: a step at M = 8 against one at M = 4,
        # the schedule's peak (the forwards, backwards and the closure's
        # backward) read before apply_gradients, whose own peak comes after
        def peak_of(rows, seed):
            xb, yb = batch(seed, rows)
            torch.cuda.synchronize()
            alive = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(xb, yb)
            torch.cuda.synchronize()
            sched = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state.apply_gradients()
            torch.cuda.synchronize()
            return alive, sched, torch.cuda.max_memory_allocated()
        (alive4, sched4, apply4), (alive8, sched8, apply8) = (
            peak_of(b, 27), peak_of(2 * b, 28))
        # O(M) by design: per microbatch the stacked input, the embedding
        # output kept for the closure's backward and its input cotangent,
        # (mb, s, hidden) in bf16 each
        per_mb = 3 * mb * s * cfg.hidden_size * 2
        allowed = sched4 + (b // mb) * per_mb + 64 * 2 ** 20
        stats.update(alive_at_start=alive_at_start, alive_before_step=alive4,
                     schedule_peak_m4=sched4, schedule_peak_m8=sched8,
                     schedule_peak_allowed_m8=allowed, apply_peak_m4=apply4,
                     apply_peak_m8=apply8, alive_before_step_m8=alive8)
        log(f"  memory: alive at the phase's start {alive_at_start}, "
            f"before a step {alive4}; schedule peak M=4 {sched4} M=8 "
            f"{sched8} (allowed {allowed}); apply_gradients peak M=4 "
            f"{apply4} M=8 {apply8} (bytes)")
        ok &= gate("GPT-2 1.3B pipeline: the schedule's peak memory flat in "
                   "M (M=8 within M=4's plus the O(M) buffers and 64 MiB)",
                   sched8 <= allowed)
        stats["memory_breakdown"] = _memory_breakdown(
            torch, lambda: step(x, y), {"model": model, "train state": state})
        log(f"  memory breakdown: {json.dumps(stats['memory_breakdown'])}")
        del model, state, outs
        torch.cuda.empty_cache()
    finally:
        destroy_distributed()
    return ok, stats


# ------------------------------------------------------------------ #
# context parallelism, the expert axis, tensor-parallel serving
# ------------------------------------------------------------------ #
CP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def _ms_call(torch, fn, n=3):
    """Mean device ms of ``n`` calls of ``fn`` (CUDA events, after one
    untimed call) and its last output."""
    out = fn()
    ms, outs, _ = _event_times(torch, fn, n)
    return sum(ms) / n, outs[-1]


def _attn_fwd_bwd(torch, fn, q, k, v, do):
    """``fn(q, k, v)`` and the gradients of ``sum(o * do)``."""
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = fn(*xs)
    dq, dk, dv = torch.autograd.grad(o, xs, do)
    return o.detach(), dq, dk, dv


def _max_err(torch, got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


#: the ring's agreement bounds, |got - want| <= bound * (|want| +
#: rms(want)) at every element of o, dq, dk and dv: the kernel ring
#: against fused_attention's kernels, and against the plain ring, whose
#: bf16 composition rounds in other places (PERF.md §6, PR 22: the
#: measured readings and two planted faults between which they sit)
BF16_AGREE = 2.0 ** -5
PLAIN_AGREE = 2.0 ** -4


def _agreement(torch, got, want):
    """Per tensor, the largest ``|g - w| / (|w| + rms(w))``: each
    element's error against its own magnitude, floored by the tensor's
    RMS (the late rows of a long causal ``o`` average thousands of keys
    and sit far below its largest values)."""
    out = []
    for g, w in zip(got, want):
        w = w.float()
        floor = w.pow(2).mean().sqrt()
        out.append(float(((g.float() - w).abs() / (w.abs() + floor)).max()))
    return out


def _planted_fault(torch, fault, fn):
    """``fn()`` with a fault planted in the ring's merge: ``"dropped"``
    leaves the last rank's chunk 0 out of its merge, ``"natural"``
    takes the flash kernels' log2 ``lse`` for a natural logarithm."""
    import importlib
    import math

    # the module, not the function the package exports under its name
    ra = importlib.import_module("apex_tpu_torch.parallel.ring_attention")
    tick, merge = ra._fwd_tick, ra._merge

    def dropped(q, kc, vc, rank, src, cp, state, **kw):
        if rank == cp - 1 and src == 0:
            return state
        return tick(q, kc, vc, rank, src, cp, state, **kw)

    def natural(o1, lse1, o2, lse2):
        o, lse = merge(o1, lse1 / math.log(2), o2, lse2 / math.log(2))
        return o, lse * math.log(2)

    if fault == "dropped":
        ra._fwd_tick = dropped
    else:
        ra._merge = natural
    try:
        return fn()
    finally:
        ra._fwd_tick, ra._merge = tick, merge


def phase_context_parallel(torch, s=32768):
    """Phase 27: context parallelism at Mistral-7B's attention widths (32
    q heads, 8 kv heads, d 128), bf16, b 1, causal, S = 32768, at a
    world of one over NCCL: ring attention (one tick) forward and
    dq / dk / dv bitwise equal to ``fused_attention``, ``remat=True``
    bitwise equal to ``remat=False``; the virtual ring at cp 4 (chunks of
    8192) within ``BF16_AGREE`` (per element) of ``fused_attention`` on
    the whole sequence, with 10 forward chunk launches of 16 (the dead
    chunks skipped), while two faults planted in its merge (a chunk
    dropped, the lse's domain) fall outside ``PLAIN_AGREE``; the kernel
    ring within ``PLAIN_AGREE`` of the plain ring at S = 4096;
    Ulysses bitwise equal to ``fused_attention``, and with a window of
    4096.  The ms of each call, the bytes one call adds at its peak and
    the phase's peak."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops.attention import fused_attention
    from apex_tpu_torch.parallel import (
        ring_attention,
        ulysses_attention,
        virtual_ring_attention,
    )
    from apex_tpu_torch.parallel.launch import destroy_distributed

    log(f"phase 27: ring attention and Ulysses, Mistral-7B attention "
        f"(32 / 8 heads, d 128), bf16, b=1, S={s}, causal, world of one")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)

    def inputs(n):
        return [torch.randn(shp, generator=g, device=dev,
                            dtype=torch.bfloat16) for shp in (
            (1, n, 32, 128), (1, n, 8, 128), (1, n, 8, 128),
            (1, n, 32, 128))]

    ok, st = True, {}
    try:
        ok &= gate("world of one over NCCL", _world_of_one(torch))
        q, k, v, do = inputs(s)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls = {
            "fused": lambda a, b, c: fused_attention(a, b, c, causal=True),
            "ring": lambda a, b, c: ring_attention(a, b, c, causal=True),
            "ring_remat": lambda a, b, c: ring_attention(
                a, b, c, causal=True, remat=True),
            "ring_virtual_cp4": lambda a, b, c: virtual_ring_attention(
                a, b, c, 4, causal=True),
            "ulysses": lambda a, b, c: ulysses_attention(a, b, c,
                                                         causal=True),
            "fused_window": lambda a, b, c: fused_attention(
                a, b, c, causal=True, window=4096),
            "ulysses_window": lambda a, b, c: ulysses_attention(
                a, b, c, causal=True, window=4096),
        }
        out, ms, peak = {}, {}, {}
        for name, fn in calls.items():
            ms[name], out[name] = _ms_call(
                torch, lambda fn=fn: _attn_fwd_bwd(torch, fn, q, k, v, do))
            # one more call alone: the bytes its forward and backward add
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _attn_fwd_bwd(torch, fn, q, k, v, do)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() - base
        st.update(ms_fwd_bwd=ms, peak_bytes_of_a_call=peak)

        def bitwise(a, b):
            return all(torch.equal(x, y) for x, y in zip(out[a], out[b]))
        ok &= gate("ring at a world of one == fused_attention bitwise",
                   bitwise("ring", "fused"))
        ok &= gate("ring remat == ring bitwise",
                   bitwise("ring_remat", "ring"))
        ok &= gate("ulysses == fused_attention bitwise",
                   bitwise("ulysses", "fused"))
        ok &= gate("ulysses window 4096 == fused_attention window bitwise",
                   bitwise("ulysses_window", "fused_window"))
        err = _max_err(torch, out["ring_virtual_cp4"], out["fused"])
        st["virtual_cp4_max_abs_err"] = err
        st["virtual_cp4_max_abs_err_by_tensor"] = [
            float((a.float() - b.float()).abs().max()) for a, b in zip(
                out["ring_virtual_cp4"], out["fused"])]
        st["agreement_bounds"] = [BF16_AGREE, PLAIN_AGREE]
        agree = _agreement(torch, out["ring_virtual_cp4"], out["fused"])
        st["virtual_cp4_agreement"] = agree
        ok &= gate(f"virtual ring cp 4 within {BF16_AGREE} of fused per "
                   f"element (o, dq, dk, dv: {agree})",
                   max(agree) <= BF16_AGREE)
        for fault in ("dropped", "natural"):
            bad = _agreement(torch, _planted_fault(
                torch, fault, lambda: _attn_fwd_bwd(
                    torch, calls["ring_virtual_cp4"], q, k, v, do)),
                out["fused"])
            st[f"planted_{fault}_agreement"] = bad
            ok &= gate(f"planted fault {fault!r} outside {PLAIN_AGREE} "
                       f"on every tensor ({bad})", min(bad) > PLAIN_AGREE)
        # the main-path run: counts set to 0, one forward and backward
        _build.reset_launches()
        _attn_fwd_bwd(torch, calls["ring_virtual_cp4"], q, k, v, do)
        torch.cuda.synchronize()
        st["launches"] = {n: _build.launches[n] for n in CP_KERNELS}
        ok &= gate(f"virtual cp 4 launches {st['launches']}: 10 of 16 "
                   f"chunks live", all(_build.launches[n] == 10
                                       for n in CP_KERNELS))
        del q, k, v, do, out
        torch.cuda.empty_cache()
        # the kernel ring against the plain ring at S = 4096
        q, k, v, do = inputs(4096)
        got = _attn_fwd_bwd(torch, calls["ring_virtual_cp4"], q, k, v, do)
        plain = _attn_fwd_bwd(torch, lambda a, b, c: virtual_ring_attention(
            a, b, c, 4, causal=True, implementation="torch"), q, k, v, do)
        st["plain_ring_4096_max_abs_err"] = _max_err(torch, got, plain)
        agree = _agreement(torch, got, plain)
        st["plain_ring_4096_agreement"] = agree
        ok &= gate(f"kernel ring within {PLAIN_AGREE} of the plain ring "
                   f"per element ({agree})", max(agree) <= PLAIN_AGREE)
        st["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {json.dumps(st)}")
    finally:
        destroy_distributed()
    torch.cuda.empty_cache()
    return ok, st


def phase_expert_axis(torch, b=2, s=1024):
    """Phase 28: one MoE layer at Mixtral-8x7B's widths (hidden 4096, ffn
    14336, 8 experts, top 2, SwiGLU experts, no biases), bf16, b=2 x
    s=1024, at cf 1.25: on a world-of-one NCCL mesh with
    ``expert_axis="tensor"`` (each rank dispatches to its experts and
    the parts are all-reduced) and ``"data"`` (the token all-to-all to
    the experts' owners and back), the output, aux and every gradient
    (the gate's, the experts', the input's) bitwise equal to the same
    layer without a mesh.  The ms of each forward and backward (the plain
    layer's before and after the others)."""
    from apex_tpu_torch.parallel.launch import destroy_distributed
    from apex_tpu_torch.transformer.moe import MoEConfig, MoEMLP

    log(f"phase 28: MoE expert axis at Mixtral-8x7B widths, bf16, b={b} "
        f"s={s}, world of one")
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def config(axis):
        return MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                         hidden_size=4096, ffn_hidden_size=14336,
                         activation="silu", gated=True, use_bias=False,
                         expert_axis=axis, dtype=bf, param_dtype=bf)

    g = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn((b, s, 4096), generator=g, device=dev, dtype=bf)
    dy = torch.randn((b, s, 4096), generator=g, device=dev, dtype=bf)
    plain = MoEMLP(config("tensor"), device=dev)
    plain.init_weights(torch.Generator(device=dev).manual_seed(29))
    sd = plain.state_dict()

    def run(layer):
        layer.zero_grad(set_to_none=True)
        xi = x.detach().requires_grad_(True)
        y, aux = layer(xi)
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])
        return [y.detach(), aux.detach(), xi.grad] + [
            p.grad for _, p in layer.named_parameters()]

    ok, st = True, {}
    try:
        want = run(plain)
        st["plain_ms"], _ = _ms_call(torch, lambda: run(plain))
        ok &= gate("world of one over NCCL", _world_of_one(torch))
        for axis in ("tensor", "data"):
            layer = MoEMLP(config(axis), device=dev)
            layer.load_state_dict(sd)
            got = run(layer)
            st[f"{axis}_ms"], _ = _ms_call(torch, lambda: run(layer))
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            st[f"{axis}_bitwise"] = same
            ok &= gate(f"expert_axis={axis!r}: output, aux and gradients "
                       f"bitwise ({same})", all(same) and layer.ep_active)
            del layer, got
        # the plain layer again: its first timing ran before the others
        st["plain_ms_after"], _ = _ms_call(torch, lambda: run(plain))
        st["aux"] = float(want[1])
        st["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {json.dumps(st)}")
    finally:
        destroy_distributed()
    del plain, sd, want
    torch.cuda.empty_cache()
    return ok, st


def _engine_decode(torch, eng, prompts):
    """Steady decode of ``prompts`` (phase 6's): the step ms, tokens/s,
    the tokens each slot emitted, and the profiler's device busy ms and
    idle share over 4 more steps; the slots released after."""
    step_ms, _, tokens = _steady_decode(eng, prompts)
    prof = _profile_steps(torch, eng, n=4)
    toks = [list(eng._tenants[i].gen) for i in range(len(prompts))]
    for slot in range(len(prompts)):
        eng.release(slot)
    wall, busy = prof["wall_ms_per_step"], prof["device_busy_ms_per_step"]
    return toks, dict(tokens_per_s=tokens / (sum(step_ms) / 1e3),
                      step_ms_min=min(step_ms), wall_ms_per_step=wall,
                      device_busy_ms_per_step=busy,
                      host_ms_per_step=max(0.0, wall - busy),
                      device_idle_share=prof["device_idle_share"])


def phase_tp_serving(torch):
    """Phase 29: Llama-2-7B (phase 3's seeded weights) at full width and
    depth, bf16, through the tensor-parallel engine at a world of one
    over NCCL — ``PagedEngine(mesh=<Mesh>)`` and
    ``InferenceServer(kv_cache="paged", mesh=...)``, every collective of
    the tensor-parallel path called — beside the single-chip engine in
    the same call: phase 6's steady decode at 4 and 8 slots of ~500-token
    contexts, greedy (pool 16384, pages of 16, chunks of 128), tokens
    identical; 8 greedy requests through each server, results identical;
    4 slots on int8 pages, identical to the single-chip int8 engine;
    ``health()`` with ``chips_per_replica`` 1 and the mesh shape.  Decode
    tokens/s, TTFT p50/p99, host and device ms a step, the device's idle
    share and peak bytes of each."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.core.mesh import get_mesh
    from apex_tpu_torch.models import LlamaModel
    from apex_tpu_torch.parallel.launch import destroy_distributed
    from apex_tpu_torch.serving import InferenceServer, PagedEngine

    log("phase 29: Llama-2-7B bf16 tensor-parallel paged serving at a "
        "world of one (NCCL) beside the single-chip engine")
    ok, st = True, {}
    single = llama2_7b(torch)
    prompts = serve_prompts(torch)
    four = prompts[-4:][::-1]
    reqs = [(p, dict(max_new_tokens=32)) for p in prompts]
    kw = dict(max_slots=8, block_size=16, prefill_chunk=128,
              pool_tokens=16384)
    try:
        ok &= gate("world of one over NCCL", _world_of_one(torch))
        tp = LlamaModel(single.cfg, device=single.device)
        tp.load_state_dict(single.state_dict())
        mesh = get_mesh()
        toks = {}
        for tag, model, extra in (("single", single, {}),
                                  ("tp", tp, dict(mesh=mesh))):
            row = {}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = PagedEngine(model, **kw, **extra)
            _build.reset_launches()
            toks[tag + "_4"], row["decode4"] = _engine_decode(
                torch, eng, four)
            toks[tag + "_8"], row["decode8"] = _engine_decode(
                torch, eng, prompts)
            row["launches"] = dict(_build.launches)
            row["chips_per_replica"] = eng.chips_per_replica
            row["mesh_shape"] = eng.mesh_shape
            ok &= eng.blocks_in_use == 0
            del eng
            srv = InferenceServer(model, kv_cache="paged", **kw, **extra)
            srv.start()
            toks[tag + "_server"], wall, _, _ = _serve_run(torch, srv, reqs)
            row.update(srv.latency_summary(), serve_wall_s=wall)
            row["health"] = {k: v for k, v in srv.health().items() if k in (
                "chips_per_replica", "mesh_shape", "status")}
            srv.shutdown()
            ok &= srv.error is None
            del srv
            torch.cuda.empty_cache()
            eng = PagedEngine(model, **kw, kv_dtype="int8", **extra)
            toks[tag + "_int8"], row["decode4_int8"] = _engine_decode(
                torch, eng, four)
            del eng
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            st[tag] = row
            log(f"  {tag}: {json.dumps(row)}")
        for case in ("4", "8", "server", "int8"):
            ok &= gate(f"tp engine tokens == single-chip ({case})",
                       toks["tp_" + case] == toks["single_" + case])
        ok &= gate("every step emitted", all(
            len(t) > 0 for case in ("4", "8") for t in toks["tp_" + case]))
        ok &= gate("health: chips_per_replica 1 and the mesh shape",
                   st["tp"]["health"].get("chips_per_replica") == 1
                   and st["tp"]["health"].get("mesh_shape")
                   == {"tensor": 1})
        ok &= all(st["tp"]["launches"][n] > 0 for n in PAGED_KERNELS)
        st["launches"] = st["tp"]["launches"]
    finally:
        destroy_distributed()
        del single
        torch.cuda.empty_cache()
    return ok, st


def _vit_attention_ms(torch, b, cfg, per_step):
    """``{kernel: {route, ms, launches, ms_per_step}, "total": ms}``: the
    flash kernels at ViT-Huge's attention shape in bf16, device ms a call
    between CUDA events (enqueue hidden), times launches a step."""
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    h = cfg.num_heads
    d = cfg.hidden_size // h
    s = (cfg.image_size // cfg.patch_size) ** 2 + 1
    g = torch.Generator(device=dev).manual_seed(52)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    args = (None, d ** -0.5, False, None, 0.0, 0)
    o, lse = A.flash_fwd_kernel(q, k, v, *args)
    bw = (q, k, v, None, do, lse, A.attention_delta(do, o)) + args[1:]
    calls = {"flash_attention_fwd": ("fwd", lambda: A.flash_fwd_kernel(
                 q, k, v, *args)),
             "flash_attention_bwd_dq": ("dq", lambda: A.flash_bwd_dq_kernel(
                 *bw)),
             "flash_attention_bwd_dkv": ("dkv",
                                         lambda: A.flash_bwd_dkv_kernel(*bw))}
    out, total = {}, 0.0
    for name, (kn, fn) in calls.items():
        ms = queued_event_ms(torch, fn, 20)
        n = per_step.get(name, 0)
        out[name] = dict(route=A.flash_route(kn, torch.bfloat16, d), ms=ms,
                         launches=n, ms_per_step=ms * n)
        total += ms * n
    out["total_ms_per_step"] = total
    out["shape"] = (b, s, h, d)
    log(f"  ViT-Huge attention by launches: {json.dumps(out)}")
    del q, k, v, do, o, lse, bw
    return out


def _profile_steps(torch, eng, n=4, groups=None):
    """Device time by kernel over ``n`` engine steps after one more, and
    the share of the window the device was idle (torch.profiler,
    CUPTI); ``groups`` as in :func:`_profile_train`."""
    from torch.profiler import ProfilerActivity, profile

    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.monotonic()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = []
    for e in p.key_averages():
        if _is_kernel(e) and _device_us(e) > 0:
            rows.append((_device_us(e), e.key, e.count))
    return _profile_summary(rows, n, wall_us, groups)


def _profile_summary(rows, n, wall_us, groups=None):
    """Per-step device busy ms, idle share and the 15 costliest kernels
    of ``rows`` ((device us, kernel name, calls) over ``n`` steps of
    ``wall_us``); ``groups`` (name -> regex on the kernel name) adds the
    device ms per step of each group, the rest under "other"."""
    rows = sorted(rows, reverse=True)
    busy = sum(r[0] for r in rows)
    out = dict(steps=n, wall_ms_per_step=wall_us / n / 1e3,
               kernels_per_step=sum(r[2] for r in rows) / n,
               device_busy_ms_per_step=busy / n / 1e3,
               device_idle_share=max(0.0, 1 - busy / wall_us),
               top=[dict(kernel=k[:90], ms_per_step=us / n / 1e3,
                         calls_per_step=c / n) for us, k, c in rows[:15]])
    if groups:
        split = dict.fromkeys(list(groups) + ["other"], 0.0)
        for us, key, _ in rows:
            name = next((k for k, pat in groups.items()
                         if re.search(pat, key)), "other")
            split[name] += us / n / 1e3
        out["device_ms_per_step_by_group"] = split
    return out


# the Hopper kernels of each library, by kind, and the SASS instructions
# every variant of a kind must show: wgmma products (HGMMA) and TMA tile
# loads (UTMALDG), or bulk copies (UBLKCP); LDGSTS (cp.async) is counted
_WGMMA_TMA = ("HGMMA", "UTMALDG")
HOPPER_KINDS = {
    "flash_attention": {"fa_fwd_wgmma": _WGMMA_TMA,
                        "fa_bwd_dq_wgmma": _WGMMA_TMA,
                        "fa_bwd_dkv_wgmma": _WGMMA_TMA},
    "paged_attention": {"paged_attn_wgmma": _WGMMA_TMA,
                        "paged_attn_split": ("UBLKCP",),
                        "paged_decode_split": ("UBLKCP",)},
    "fp8_adam": {"fp8_adam_kernel": ("UTMALDG", "UBLKCP")},
}
SASS_COUNTS = ("HGMMA", "UTMALDG", "UBLKCP", "LDGSTS")
# kernels that must use no local memory (no LDL / STL, no stack frame, no
# spills) and make at most this many calls, (library, kind, calls, an
# instruction every variant needs): the sampler's one call is the IEEE
# quotient for the load's rare operands (|x| off [2^-60, 2^60]), never
# inside the selection passes or the draw; the softmax forward's
# reciprocal has no slow path; the GroupNorm cluster kernels' quotients
# and sigmoid take CUDA's fast paths.  The sampler stages its slice by
# bulk copy (UBLKCP), the GroupNorm cluster kernels their slabs by TMA
# (UTMALDG)
CALL_LIMITS = (("fused_sampling", "sample_cluster_kernel", 1, "UBLKCP"),
               ("softmax", "softmax_fwd_rows_kernel", 0, None),
               ("softmax", "softmax_bwd_rows_kernel", 0, None),
               ("rope", "rope_kernel", 0, None),
               ("group_norm", "gn_fwd_cluster_kernel", 0, "UTMALDG"),
               ("group_norm", "gn_bwd_cluster_kernel", 0, "UTMALDG"))


def _hopper_report(_build, build_logs):
    """Each Hopper kernel's ``-Xptxas -v`` lines (registers, shared
    memory, spills) and the count of its ``HGMMA``, ``UTMALDG``,
    ``UBLKCP`` and ``LDGSTS`` instructions in the built library's SASS
    (``cuobjdump -sass``), by kind (:data:`HOPPER_KINDS`: the flash
    forward, dq and dk/dv; the paged chunk kernel and the two split-K
    kernels; the fp8 Adam step's TMA and bulk copies), and a line for
    the head-dim-80 instances of the forward, dq and dk/dv.  Raises
    when a kind is missing, when a variant lacks an instruction its kind
    needs, when this build printed no ``-Xptxas -v`` line for one (the
    library was not compiled in this call), when one spills, or when the
    forward, dq or dk/dv lacks any of its 16 head-dim-80 variants."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib, kinds in HOPPER_KINDS.items():
        def kind_of(fn):
            return [k for k in kinds if k in fn]
        found = {}
        fn = None
        for line in build_logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and kind_of(fn) and ("Used" in line or "spill" in line):
                found.setdefault(fn, dict(ptxas=[]))["ptxas"].append(
                    line.strip())
        sass = subprocess.run([tool, "-sass", str(_build._paths[lib])],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if kind_of(m.group(1)) else None
            elif fn:
                rec = found.setdefault(fn, dict(ptxas=[]))
                for ins in SASS_COUNTS:
                    rec[ins] = rec.get(ins, 0) + (ins in line)
        groups = {}
        for fn, rec in found.items():
            kind = kind_of(fn)
            if len(kind) != 1:
                raise RuntimeError(f"kernel {fn} is not one of {list(kinds)}")
            rec["kind"] = kind[0]
            key = (kind[0],) + tuple(rec.get(i, 0) for i in SASS_COUNTS) + (
                " | ".join(rec["ptxas"]),)
            groups[key] = groups.get(key, 0) + 1
        for (kind, *counts, px), n in sorted(groups.items()):
            txt = " ".join(f"{i} {c}" for i, c in zip(SASS_COUNTS, counts))
            log(f"  {kind} x{n} variants: {txt} | {px}")
        missing = [k for k in kinds if not any(
            r["kind"] == k for r in found.values())]
        short = [fn for fn, r in found.items()
                 if not all(r.get(i) for i in kinds[r["kind"]])]
        if missing or short:
            raise RuntimeError(
                f"the Hopper kernels of {lib}: kinds {missing} missing; "
                f"{short} lack the instructions of their kind ({kinds})")
        out.update(found)
    # head dim 80 (16-column panels): the forward, dq and dk/dv in every
    # variant of both half types, 8 x 2 instances each (mangled "Li80E")
    for kind in ("fa_fwd_wgmma", "fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma"):
        d80 = [r for fn, r in out.items()
               if r.get("kind") == kind and "Li80E" in fn]
        spill = sum(int(n) for r in d80 for px in r["ptxas"]
                    for n in re.findall(r"(\d+) bytes spill", px))
        log(f"  {kind} d=80: {len(d80)} variants; HGMMA in "
            f"{sum(bool(r.get('HGMMA')) for r in d80)}, UTMALDG in "
            f"{sum(bool(r.get('UTMALDG')) for r in d80)}; spill bytes "
            f"{spill}")
        if len(d80) != 16:
            raise RuntimeError(f"{kind}: {len(d80)} head-dim-80 variants "
                               "built, 16 expected")
    unread = [fn for fn, r in out.items() if not r["ptxas"]]
    if unread:
        raise RuntimeError("no -Xptxas -v line from this build for the "
                           f"Hopper kernels {unread}: spills unchecked")
    spilled = [fn for fn, r in out.items() if any(
        int(n) for px in r["ptxas"]
        for n in re.findall(r"(\d+) bytes spill", px))]
    if spilled:
        raise RuntimeError(f"Hopper kernels spill: {spilled}")
    return out


def _call_report(_build, build_logs):
    """Per variant of the kernels of :data:`CALL_LIMITS`, the counts of
    ``CALL``, ``LDL``, ``STL``, ``UBLKCP`` and ``UTMALDG`` in the built
    library's SASS and its ``-Xptxas -v`` stack frame and spills.  Raises when a kernel
    is missing, uses local memory, calls more often than its limit, or
    lacks the instruction its design needs."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out, bad = {}, []
    for lib, kind, limit, need in CALL_LIMITS:
        frames, fn = {}, None
        for line in build_logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if kind in m.group(1) else None
            elif fn and "stack frame" in line:
                frames[fn] = [int(n) for n in re.findall(r"(\d+) bytes", line)]
        sass = subprocess.run([tool, "-sass", str(_build._paths[lib])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if kind in m.group(1) else None
                if fn:
                    counts[fn] = dict.fromkeys(("CALL", "LDL", "STL",
                                                "UBLKCP", "UTMALDG"), 0)
            elif fn:
                for ins in counts[fn]:
                    counts[fn][ins] += ins in line
        if not counts:
            bad.append(f"{kind}: not in the {lib} library")
        for fn, c in counts.items():
            c["frame_spill_bytes"] = frames.get(fn)
            if (c["LDL"] or c["STL"] or c["CALL"] > limit
                    or (need and not c[need]) or frames.get(fn) is None
                    or any(frames[fn])):
                bad.append(f"{fn}: {c}")
        out.update(counts)
        worst = {i: max((c[i] for c in counts.values()), default=0)
                 for i in ("CALL", "LDL", "STL")}
        least = min((c[need] for c in counts.values()), default=0) \
            if need else 0
        log(f"  {kind} x{len(counts)} variants: CALL <= {worst['CALL']} "
            f"(limit {limit}), LDL {worst['LDL']}, STL {worst['STL']}, "
            f"{need or 'copies'} >= {least}, stack frame and spills "
            f"{'0' if all(not any(c['frame_spill_bytes'] or [1]) for c in counts.values()) else 'NONZERO'}")
    if bad:
        raise RuntimeError("local memory or calls in " + "; ".join(bad))
    return out


def _occupancy_report(torch, _build):
    """Registers a thread and blocks an SM of the main path's variants of
    two kernels, from the CUDA runtime: the RoPE kernel (bf16, 16-byte vectors, 32-bit offsets, 256 threads — the
    block of a chunk or decode step) and the softmax backward's rows
    kernel (bf16 vectorised at sk 512 and 1024, and the VEC = 1 variant at
    sk 1024); a persistent grid launches that many CTAs an SM."""
    import ctypes

    ci = ctypes.c_int
    out = {}
    rope = _build.function("rope", "apex_rope_occupancy", [
        ci, ci, ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)])
    blocks, regs, smem = ci(), ci(), ci()

    def check(code):
        if code != 0:
            raise RuntimeError(f"occupancy query: CUDA error {code}")
    check(rope(1, 8, 0, 256, ctypes.byref(blocks), ctypes.byref(regs)))
    out["rope_kernel<bf16, 8, int>"] = dict(
        registers=regs.value, blocks_per_sm=blocks.value,
        warps_per_sm=blocks.value * 8)
    bwd = _build.function("softmax", "apex_softmax_bwd_occupancy", [
        ci, ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci),
        ctypes.POINTER(ci)])
    for sk, vec in ((512, 8), (1024, 8), (1024, 1)):
        check(bwd(sk, 1, vec, ctypes.byref(blocks), ctypes.byref(smem),
                  ctypes.byref(regs)))
        out[f"softmax_bwd_rows_kernel<bf16, {vec}> sk {sk}"] = dict(
            registers=regs.value, blocks_per_sm=blocks.value,
            warps_per_sm=blocks.value * 8, smem_bytes=smem.value)
    for name, r in out.items():
        log(f"  {name}: {r}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run phase 1 only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile steady decode steps in phases 3, 6 "
                         "and 7 and training steps in phases 4, 8, 15, "
                         "17, 24, 25 and 26")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after the build, "
                         "phase 1 and the kernels record left out (a "
                         "debugging aid; the full run takes no flag)")
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory for the detailed JSON record")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    build_logs = _build.build_all(ptxas_info=True)
    log(f"built {sorted(build_logs)} in {time.monotonic() - t0:.1f}s")
    build = {}
    for name, text in sorted(build_logs.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(
            r"(\d+) bytes spill stores", text))
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", text)]
        build[name] = dict(kernels=len(regs), registers=regs,
                           smem_max=max(smem, default=0),
                           spill_store_bytes=spills)
        log(f"  {name}: {len(regs)} kernels, registers <= "
            f"{max(regs, default=0)}, smem <= {max(smem, default=0)} "
            f"bytes, spill stores {spills} bytes")
    build["hopper_kernels"] = _hopper_report(_build, build_logs)
    build["no_local_memory"] = _call_report(_build, build_logs)
    build["occupancy"] = _occupancy_report(torch, _build)

    rows = []
    t0 = time.monotonic()
    only = None if args.phases is None else set(args.phases.split(","))
    PHASE_LINES.clear()
    ok = True if only else phase_kernels(torch, rows)
    if not only:
        log(f"phase 1 {'passed' if ok else 'FAILED'} "
            f"({time.monotonic() - t0:.0f}s)")
        if not ok:
            report_failure("1", PHASE_LINES)
    shared = {}

    def with_model(run):
        # Llama-2-7B is built once for phases 3, 6 and 7
        if "model" not in shared:
            shared["model"] = llama2_7b(torch)
        return run(shared["model"])

    def drop_model():
        shared.clear()
        torch.cuda.empty_cache()
        return True, None

    phases = [] if args.kernels_only else [
        ("2", lambda: (phase_identity(torch), None)),
        ("3", lambda: with_model(lambda m: phase_serve(torch, m,
                                                       args.profile))),
        ("6", lambda: with_model(lambda m: phase_paged(torch, m,
                                                       args.profile))),
        ("7", lambda: with_model(lambda m: phase_paged_int8(torch, m,
                                                            args.profile))),
        ("", drop_model),
        ("4", lambda: phase_train(torch, args.profile)),
        ("5", lambda: phase_train_identity(torch)),
        ("17", lambda: phase_train_o1(torch, args.profile)),
        ("10", lambda: phase_train_fp8(
            torch, args.profile,
            dense_peak=(results.get("4") or {}).get("peak_bytes"))),
        ("12", lambda: phase_fp8_identity(torch)),
        ("18", lambda: phase_optimizers(torch)),
        ("11", lambda: phase_softmax_chain(torch)),
        ("8", lambda: phase_resnet(torch, args.profile)),
        ("9", lambda: phase_resnet_identity(torch)),
        ("15", lambda: phase_resnet(torch, args.profile, opt_level="O1")),
        ("16", lambda: phase_resnet_o1_identity(torch)),
        ("13", lambda: phase_group_norm_block(torch)),
        ("14", lambda: phase_block_identity(torch)),
        ("19", lambda: phase_group_norm_faults(torch)),
        ("20", lambda: phase_remat(torch)),
        ("21", lambda: phase_mistral(torch)),
        ("22", lambda: phase_mixtral(torch)),
        ("23", lambda: phase_vit(torch)),
        ("24", lambda: phase_gpt_tp(torch, args.profile)),
        ("25", lambda: phase_resnet_ddp(torch, args.profile)),
        ("26", lambda: phase_gpt_pipeline(torch, args.profile,
                                          gpt_tp=results.get("24"))),
        ("27", lambda: phase_context_parallel(torch)),
        ("28", lambda: phase_expert_axis(torch)),
        ("29", lambda: phase_tp_serving(torch)),
    ]
    if only:
        phases = [(n, r) for n, r in phases if n in only]
    results = {}
    for name, run in phases:
        if not ok:
            break
        t0 = time.monotonic()
        PHASE_LINES.clear()
        try:
            ok, results[name] = run()
        except Exception:       # the phase failed: record it, then exit 1
            import traceback
            traceback.print_exc()
            PHASE_LINES.extend(traceback.format_exc().splitlines()[-6:])
            ok, results[name] = False, None
        if name:
            log(f"phase {name} {'passed' if ok else 'FAILED'} "
                f"({time.monotonic() - t0:.0f}s)")
        if not ok:
            report_failure(name, PHASE_LINES)
    (serve, paged, paged8, train, ident, resnet, resnet_ident, train_fp8,
     chain, fp8_ident, gn_block, block_ident, resnet_o1, resnet_o1_ident,
     train_o1, optimizers, gn_faults, remat, mistral, mixtral,
     vit, gpt_tp, resnet_ddp, gpt_pipe, context_par, expert_axis,
     tp_serving) = (results.get(n) for n in (
         "3", "6", "7", "4", "5", "8", "9", "10", "11", "12", "13", "14",
         "15", "16", "17", "18", "19", "20", "21", "22", "23", "24", "25",
         "26", "27", "28", "29"))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, build=build, kernel_rows=rows, serve=serve,
                       paged=paged, paged_int8=paged8, train=train,
                       train_identity=ident, resnet=resnet,
                       resnet_identity=resnet_ident, train_fp8=train_fp8,
                       softmax_chain=chain, fp8_identity=fp8_ident,
                       group_norm_block=gn_block,
                       block_identity=block_ident, resnet_o1=resnet_o1,
                       resnet_o1_identity=resnet_o1_ident,
                       train_o1=train_o1, optimizers=optimizers,
                       group_norm_faults=gn_faults, remat=remat,
                       mistral=mistral, mixtral=mixtral, vit=vit,
                       gpt_tp=gpt_tp, resnet_ddp=resnet_ddp,
                       gpt_pipe=gpt_pipe, context_parallel=context_par,
                       expert_axis=expert_axis, tp_serving=tp_serving), f,
                  indent=1)
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    if only:
        log(f"chip_smoke: phases {sorted(only)} passed (no kernels record)")
        return 0

    # one row per kernel entry at its main-path shape: decode for the
    # serving kernels, BERT-Large bf16 for the training ones, ResNet-50's
    # stage-0 bn3 (residual and ReLU) bf16 for the BatchNorm passes,
    # BERT-Large's masters for the fp8 Adam step and its scores for the
    # softmax; launches are the counts of the main-path runs (phases 3,
    # 6, 7, 4, 8, 10, 11 and 13, the O1 runs 15 and 17, 20-27 and 29)
    pick = {
        "layer_norm": ("layer_norm/stats", (8192, 1024), "torch.bfloat16"),
        "layer_norm_bwd": ("layer_norm_bwd", (8192, 1024),
                           "torch.bfloat16"),
        # q and k in one launch at the chunked-prefill step's shape
        "rope": ("rope/qk", (8, 128, 32, 128), "torch.bfloat16"),
        "fused_sampling": ("fused_sampling", (4, 32000), "torch.bfloat16"),
        # bench.py's step runs no attention mask and no dropout
        "flash_attention_fwd": ("flash_fwd/bert", (16, 512, 16, 16, 64),
                                "torch.bfloat16"),
        "flash_attention_bwd_dq": ("flash_bwd_dq/bert",
                                   (16, 512, 16, 16, 64), "torch.bfloat16"),
        "flash_attention_bwd_dkv": ("flash_bwd_dkv/bert",
                                    (16, 512, 16, 16, 64), "torch.bfloat16"),
        # chunked prefill runs B-9 on the paged path; decode runs B-10
        "paged_attention": ("paged_attn/chunk", (8, 128, 32, 32, 128),
                            "torch.bfloat16"),
        "paged_decode_fused": ("paged_decode_fused/decode",
                               (4, 1, 32, 32, 128), "torch.bfloat16"),
        **{k: (k, (401408, 256), "torch.bfloat16") for k in BN_KERNELS},
        "fp8_adam": ("fp8_adam/bert_large", None, "torch.float32"),
        "softmax_fwd": ("softmax_fwd/bert", (16, 16, 512, 512),
                        "torch.bfloat16"),
        "softmax_bwd": ("softmax_bwd/bert", (16, 16, 512, 512),
                        "torch.bfloat16"),
        # the GN cell of bench_configs.py: (8, 64x64, 512) bf16, SiLU, on
        # the cluster route; a VAE decoder's last GroupNorm (1, 512x512,
        # 128) bf16 on the three-pass route
        "group_norm_fwd": ("group_norm_fwd/main", (8, 4096, 512),
                           "torch.bfloat16"),
        "group_norm_bwd": ("group_norm_bwd/main", (8, 4096, 512),
                           "torch.bfloat16"),
        "group_norm_fwd_3pass": ("group_norm_fwd_3pass/vae", (1, 262144, 128),
                                 "torch.bfloat16"),
        "group_norm_bwd_3pass": ("group_norm_bwd_3pass/vae", (1, 262144, 128),
                                 "torch.bfloat16"),
    }
    family = {"layer_norm": ("rms_norm", "layer_norm", "layer_norm/stats"),
              "layer_norm_bwd": ("layer_norm_bwd",),
              "rope": ("rope",),
              "fused_sampling": ("fused_sampling",),
              "flash_attention_fwd": ("flash_fwd",),
              "flash_attention_bwd_dq": ("flash_bwd_dq",),
              "flash_attention_bwd_dkv": ("flash_bwd_dkv",),
              "paged_attention": ("paged_attn",),
              "paged_decode_fused": ("paged_decode_fused",),
              **{k: (k,) for k in BN_KERNELS},
              "fp8_adam": ("fp8_adam",), "softmax_fwd": ("softmax_fwd",),
              "softmax_bwd": ("softmax_bwd",),
              "group_norm_fwd": ("group_norm_fwd",),
              "group_norm_bwd": ("group_norm_bwd",),
              "group_norm_fwd_3pass": ("group_norm_fwd_3pass",),
              "group_norm_bwd_3pass": ("group_norm_bwd_3pass",)}
    kernels = []
    for name, (kname, shape, dt) in pick.items():
        match = [r for r in rows if r["kernel"] == kname and r["dtype"] == dt
                 and (shape is None or tuple(r["shape"]) == shape)]
        errs = [r["err"] for r in rows
                if r["kernel"] in family[name]
                or r["kernel"].split("/")[0] in family[name]]
        r = match[0]
        n = sum((st or {}).get("launches", {}).get(name, 0)
                for st in (serve, paged, paged8, train, resnet, train_fp8,
                           chain, gn_block, resnet_o1, train_o1, remat,
                           mistral, mixtral, vit, gpt_tp, resnet_ddp,
                           gpt_pipe, context_par, tp_serving))
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=n,
            max_abs_err=max(errs), ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
