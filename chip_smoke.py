#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py                # all phases
    python3 chip_smoke.py --kernels-only # build + phase 1 only
    python3 chip_smoke.py --profile      # + device-time breakdowns

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``,
``sm_90a``) and then runs five phases; any failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (Llama-2-7B width) and the training path's
   (BERT-Large: LayerNorm forward with statistics and backward, flash
   attention forward, dq and dk/dv; a causal GQA window case at d=128;
   the RoPE backward), with times: the kernel, its plain version, the one
   PyTorch call computing the same function where there is one (a
   yardstick only), and the bound — the larger of bytes over 3.35 TB/s
   and operations over the card's peak rate for their type.
2. Engine identity at full width and depth 2 (fp32, TF32 off): greedy
   ``InferenceServer`` results equal ``generate()``; sampled requests
   equal themselves on a rerun with the same seeds.
3. Serving: Llama-2-7B at full depth in bf16 with random weights from a
   seeded generator, served by ``InferenceServer`` (4 slots, buckets
   32/128/512) for 8 requests; every kernel of the path must launch.
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

The last lines of standard output are the card's name and power limit,
the ``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
Details also go to ``<--out>/chip_smoke.json`` (default
``build/chip_smoke``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
# H100 SXM INT32: 64 lanes per SM x 132 SMs x 1.98 GHz, counted as the
# fp32 rate is (a multiply-add as two operations)
INT32_OPS_PER_S = 33.5e12
VOCAB = 32000

_FA = "apex_tpu_torch/csrc/flash_attention.cu"
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
}
SERVING_KERNELS = ("layer_norm", "rope", "fused_sampling")
# BERT-Large O2, remat: launches per training step of each kernel entry —
# LayerNorm forward 50 (2 per layer, embedding, MLM head) plus 48
# recomputed, its backward 50; flash forward 24 plus 24 recomputed, dq
# and dk/dv 24 each
TRAIN_LAUNCHES = {"layer_norm": 98, "layer_norm_bwd": 50,
                  "flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                  "flash_attention_bwd_dkv": 24}


def log(*a):
    print(*a, flush=True)


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages()
                 if _is_kernel(e))
    return dev_us / iters / 1e3, call_ms


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
               iters=None, lib_events=False):
        """``kern`` / ``plain`` / ``lib``: functions to time (lib may be
        None); times are device ms per call, call ms beside them.
        ``lib_events``: take the library's time from the CUDA events
        (call ms) — the profiler does not see every kernel of
        ``scaled_dot_product_attention`` (it reported 0 device ms for
        its flash backend)."""
        bms, by = bound(nbytes, ops, int_ops, ops_per_s)
        if iters is None:
            iters = 20 if kernel == "fused_sampling" else 50
        t_k, t_p = timed(torch, kern, iters), timed(torch, plain, iters)
        t_l = None if lib is None else timed(torch, lib, iters)
        row = dict(kernel=kernel, shape=shape, dtype=str(dtype), err=err,
                   passed=passed, ms=t_k[0], call_ms=t_k[1],
                   plain_ms=t_p[0], plain_call_ms=t_p[1],
                   library_ms=None if t_l is None else t_l[
                       1 if lib_events else 0],
                   library_device_ms=None if t_l is None else t_l[0],
                   library_call_ms=None if t_l is None else t_l[1],
                   bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                   int_ops=int_ops, tolerance=tol)
        rows_out.append(row)
        lib_txt = "-" if t_l is None else f"{t_l[0]:.5f}/{t_l[1]:.4f}"
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
    # and per-row tables
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
                if dt == torch.float32:
                    passed = bool(torch.allclose(y, r, rtol=1e-5, atol=1e-5))
                    tol = "rtol 1e-5, atol 1e-5"
                else:
                    passed = bf16_ulp_ok(torch, y, r)
                    tol = "1 bf16 ulp"
                nbytes = 2 * x.numel() * x.element_size() + 2 * c.numel() * 4
                ops = 6 * x.numel() // 2
                ok &= record("rope" + ("/per_row" if per_row else ""),
                             shape, dt, err, passed, kern, plain, nbytes,
                             ops, None, tol)

    # fused sampling over a grid of row kinds: fp32 at the served and
    # the 128k-vocab shapes, and bf16 at the served shape, which is what
    # the Llama-2-7B bf16 head hands the engine
    grid_4 = [
        # (temperature, top_k, top_p)
        [(0.0, 0, 0.0), (0.8, 0, 0.0), (1.0, 40, 0.0), (0.9, 0, 0.9)],
        [(0.7, 50, 0.8), (1.2, 5, 0.5), (1.0, 0, 0.0), (0.0, 0, 0.0)],
    ]
    grids = [
        ((4, 32000), torch.float32, grid_4),
        ((4, 32000), torch.bfloat16, grid_4),
        ((8, 128256), torch.float32, [
            [(0.0, 0, 0.0), (0.0, 0, 0.0), (1.0, 0, 0.0), (0.6, 0, 0.0),
             (1.0, 100, 0.0), (0.8, 0, 0.95), (0.7, 40, 0.9),
             (1.1, 1000, 0.5)],
        ]),
    ]
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
            y, r = kern(), plain()
            torch.cuda.synchronize()
            mism = (y != r).nonzero().flatten().tolist()
            ties = [i for i in mism if _nucleus_tie(
                torch, logits[i], cfgs[i], int(y[i]), int(r[i]))]
            passed = len(mism) == len(ties)
            err = float((y.long() - r.long()).abs().max())
            nbytes = fs.sampling_cost_bytes(rows, vocab, logits.dtype)
            fp_ops = sum(_sampling_ops(vocab, c)[0] for c in cfgs)
            int_ops = sum(_sampling_ops(vocab, c)[1] for c in cfgs)
            log(f"  sampling {str(dt)[6:]} grid {gi}: kernel {y.tolist()} "
                f"plain {r.tolist()} nucleus ties {ties}")
            ok &= record("fused_sampling", (rows, vocab), logits.dtype,
                         err, passed, kern, plain, nbytes, fp_ops, None,
                         "tokens equal (nucleus-boundary ties excepted)",
                         int_ops=int_ops)
    ok &= _rope_backward_rows(torch, g, record)
    ok &= _layer_norm_training_rows(torch, g, record)
    ok &= _flash_rows(torch, g, record)
    ok &= _flash_edge_checks(torch, g)
    return ok


def _close_rel(torch, got, ref, rel):
    """``(max |got - ref|, passed)``: passed when the largest difference
    is within ``rel`` of the reference's largest magnitude."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err <= rel * max(scale, 1e-30)


def _rope_backward_rows(torch, g, record):
    """The RoPE backward (the same kernel with -sin) through autograd,
    against the plain version's autograd, at the prefill shape."""
    from apex_tpu_torch.ops.rope import fused_rope, rope_cos_sin

    dev = torch.device("cuda")
    cos_t, sin_t = rope_cos_sin(512, 128, device=dev)
    ok = True
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 512, 32, 128, generator=g, device=dev).to(dt)
        dy = torch.randn(x.shape, generator=g, device=dev).to(dt)

        def grad_of(impl):
            xr = x.detach().requires_grad_()
            y = fused_rope(xr, cos_t, sin_t, implementation=impl)
            return torch.autograd.grad(y, xr, dy)[0]
        got, ref = grad_of("kernel"), grad_of("torch")
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if dt == torch.float32:
            passed = bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5))
            tol = "rtol 1e-5, atol 1e-5"
        else:
            passed = bf16_ulp_ok(torch, got, ref)
            tol = "1 bf16 ulp"
        nbytes = 2 * x.numel() * x.element_size() + 2 * cos_t.numel() * 4
        ok &= record("rope/bwd", tuple(x.shape), dt, err, passed,
                     lambda: grad_of("kernel"), lambda: grad_of("torch"),
                     nbytes, 3 * x.numel(), None, tol)
    return ok


def _layer_norm_training_rows(torch, g, record):
    """LayerNorm forward with saved statistics and the dx backward at
    the training shapes (b*s = 8192 rows and the 16*80 = 1280 gathered
    MLM rows of BERT-Large), bf16 activations with fp32 weights as under
    amp O2, and fp32."""
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
    bf16 and fp32.  The library yardstick is
    ``F.scaled_dot_product_attention`` forward, and forward+backward for
    the backward pair."""
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
    ]
    ok = True
    for tag, c in cases:
        for dt in (torch.bfloat16, torch.float32):
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
            # fp32: sums in another order; bf16: outputs round to 8 bits
            rel = 1e-5 if dt == torch.float32 else 2 ** -7
            tol = f"max |err| <= {rel:g} x max |ref| per output"
            live = lse2 > -1e29
            e_o, p_o = _close_rel(torch, o, o2, rel)
            e_l, p_l = _close_rel(torch, lse[live], lse2[live], 1e-5)
            e_q, p_q = _close_rel(torch, dq, dq2, rel)
            e_k, p_k = _close_rel(torch, dk, dk2, rel)
            e_v, p_v = _close_rel(torch, dv, dv2, rel)
            p_dead = bool((lse[~live] < -1e29).all())
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

            isz = q.element_size()
            pairs = visible_pairs(s, s, c["causal"], c["window"])
            bias_bytes = 0 if bias is None else bias.numel() * 4
            qo = 2 * b * s * h * d * isz
            kv = 2 * b * s * hk * d * isz
            io_f = qo + kv + b * h * s * 4 + bias_bytes
            io_b = io_f + qo + kv
            flops = 2 * b * h * pairs * d
            peak = FP32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
            shape = (b, s, h, hk, d)
            it = 20
            ok &= record(f"flash_fwd/{tag}", shape, dt, max(e_o, e_l),
                         p_o and p_l and p_dead,
                         lambda: A.flash_fwd_kernel(q, k, v, *args),
                         lambda: A.flash_fwd_reference(q, k, v, *args),
                         io_f, 2 * flops, lib_fwd, tol, ops_per_s=peak,
                         iters=it, lib_events=True)
            ok &= record(f"flash_bwd_dq/{tag}", shape, dt, e_q, p_q,
                         lambda: A.flash_bwd_dq_kernel(*bw),
                         lambda: A.flash_bwd_dq_reference(*bw),
                         io_b, 4 * flops, lib_fwd_bwd, tol + "; bound and "
                         "library of the dq + dk/dv pair", ops_per_s=peak,
                         iters=it, lib_events=True)
            ok &= record(f"flash_bwd_dkv/{tag}", shape, dt, max(e_k, e_v),
                         p_k and p_v,
                         lambda: A.flash_bwd_dkv_kernel(*bw),
                         lambda: A.flash_bwd_dkv_reference(*bw),
                         io_b, 4 * flops, lib_fwd_bwd, tol + "; bound and "
                         "library of the dq + dk/dv pair", ops_per_s=peak,
                         iters=it, lib_events=True)
            del o2, lse2, dq2, dk2, dv2
            torch.cuda.empty_cache()
    return ok


def _flash_edge_checks(torch, g):
    """The flash kernels against their plain versions where the timed
    shapes do not reach: ragged tiles (sq, sk not multiples of 64), rows
    with no visible key (causal sq > sk, a bias masking a whole row),
    GQA with a window, dropout under a bias, fp16, and head_dim 72 (the
    FMA kernels for half inputs); fp32, bf16 and fp16 each.  Correctness
    only, at small shapes."""
    from apex_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    # (b, sq, sk, h, hk, d, causal, window, bias shape, dropout rate)
    cases = [(2, 100, 130, 4, 4, 64, False, None, None, 0.0),
             (2, 96, 64, 2, 2, 64, True, None, None, 0.0),
             (2, 200, 200, 4, 1, 128, True, 50, None, 0.0),
             (2, 128, 128, 4, 4, 64, False, None, (2, 1, 1, 128), 0.1),
             (2, 72, 136, 4, 4, 72, False, None, (1, 4, 72, 136), 0.0)]
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
                f"window={window} bias={bs} rate={rate} {str(dt)[6:]}: "
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
    del model
    torch.cuda.empty_cache()
    return ok


# ------------------------------------------------------------------ #
# phase 3: the slice — Llama-2-7B bf16 served end to end
# ------------------------------------------------------------------ #
def phase_serve(torch, profile=False):
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import (
        LlamaConfig, LlamaModel, init_cache, prefill_tokens)
    from apex_tpu_torch.serving import InferenceServer

    log("phase 3: Llama-2-7B bf16, InferenceServer, 8 requests")
    dev = torch.device("cuda")
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = LlamaModel(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in model.parameters())} params "
        f"in {time.monotonic() - t0:.1f}s")
    gen = torch.Generator().manual_seed(4)
    lens = (20, 57, 130, 250, 333, 410, 480, 500)
    prompts = [torch.randint(0, VOCAB, (n,), generator=gen).numpy()
               for n in lens]
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
    for slot in range(eng.max_slots):
        eng.admit(slot, prompts[-1 - slot], max_new_tokens=64)
    eng.step()
    step_ms, windows = [], []
    for _ in range(3):
        t_w = time.monotonic()
        for _ in range(16):
            t0 = time.monotonic()
            eng.step()
            step_ms.append((time.monotonic() - t0) * 1e3)
        windows.append((time.monotonic() - t_w) / 16 * 1e3)
    decode_s = sum(step_ms) / 1e3
    prof = _profile_steps(torch, eng) if profile else None
    for slot in range(eng.max_slots):
        eng.release(slot)
    stats = dict(requests=len(results), tokens=ntok, steps=steps,
                 wall_s=wall, warmup_s=warm_s,
                 serve_tokens_per_s=ntok / wall, launches=launches,
                 decode_steps=len(step_ms), decode_s=decode_s,
                 decode_tokens_per_s=len(step_ms) * eng.max_slots / decode_s,
                 decode_step_ms_windows=windows,
                 decode_step_ms_min=min(step_ms),
                 decode_step_ms_max=max(step_ms),
                 peak_bytes=peak, logits_finite=finite, **lat)
    log(f"  {json.dumps(stats)}")
    if prof is not None:
        stats["profile"] = prof
        log(f"  profile: {json.dumps(prof)}")
    ok &= all(launches[n] > 0 for n in SERVING_KERNELS)
    del model, one, eng, srv
    torch.cuda.empty_cache()
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
    prof = _profile_train(torch, train_step) if profile else None
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


def _profile_train(torch, train_step, n=2):
    """Device time by kernel over ``n`` training steps, and the share of
    the window the device was idle (torch.profiler, CUPTI)."""
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
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(steps=n, wall_ms_per_step=wall_us / n / 1e3,
                device_busy_ms_per_step=busy / n / 1e3,
                device_idle_share=max(0.0, 1 - busy / wall_us),
                top=[dict(kernel=k[:90], ms_per_step=us / n / 1e3,
                          calls_per_step=c / n) for us, k, c in rows[:15]])


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


def _profile_steps(torch, eng, n=4):
    """Device time by kernel over ``n`` steady decode steps, and the
    share of the window the device was busy (torch.profiler, CUPTI)."""
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
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(steps=n, wall_ms_per_step=wall_us / n / 1e3,
                device_busy_ms_per_step=busy / n / 1e3,
                device_idle_share=max(0.0, 1 - busy / wall_us),
                top=[dict(kernel=k[:90], ms_per_step=us / n / 1e3,
                          calls_per_step=c / n) for us, k, c in rows[:15]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run phase 1 only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile steady decode steps in phase 3 and "
                         "training steps in phase 4")
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
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows = []
    t0 = time.monotonic()
    ok = phase_kernels(torch, rows)
    log(f"phase 1 {'passed' if ok else 'FAILED'} "
        f"({time.monotonic() - t0:.0f}s)")
    serve = train = ident = None
    phases = [] if args.kernels_only else [
        ("2", lambda: (phase_identity(torch), None)),
        ("3", lambda: phase_serve(torch, args.profile)),
        ("4", lambda: phase_train(torch, args.profile)),
        ("5", lambda: phase_train_identity(torch)),
    ]
    results = {}
    for name, run in phases:
        if not ok:
            break
        t0 = time.monotonic()
        ok, results[name] = run()
        log(f"phase {name} {'passed' if ok else 'FAILED'} "
            f"({time.monotonic() - t0:.0f}s)")
    serve, train, ident = (results.get(n) for n in ("3", "4", "5"))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernel_rows=rows, serve=serve,
                       train=train, train_identity=ident), f, indent=1)
    if not ok:
        log("chip_smoke: FAILED")
        return 1

    # one row per kernel entry at its main-path shape: decode for the
    # serving kernels, BERT-Large bf16 for the training ones; launches
    # are the counts of the serving (phase 3) and training (phase 4)
    # main-path runs
    pick = {
        "layer_norm": ("layer_norm/stats", (8192, 1024), "torch.bfloat16"),
        "layer_norm_bwd": ("layer_norm_bwd", (8192, 1024),
                           "torch.bfloat16"),
        "rope": ("rope/per_row", (4, 1, 32, 128), "torch.bfloat16"),
        "fused_sampling": ("fused_sampling", (4, 32000), "torch.bfloat16"),
        # bench.py's step runs no attention mask and no dropout
        "flash_attention_fwd": ("flash_fwd/bert", (16, 512, 16, 16, 64),
                                "torch.bfloat16"),
        "flash_attention_bwd_dq": ("flash_bwd_dq/bert",
                                   (16, 512, 16, 16, 64), "torch.bfloat16"),
        "flash_attention_bwd_dkv": ("flash_bwd_dkv/bert",
                                    (16, 512, 16, 16, 64), "torch.bfloat16"),
    }
    family = {"layer_norm": ("rms_norm", "layer_norm", "layer_norm/stats"),
              "layer_norm_bwd": ("layer_norm_bwd",),
              "rope": ("rope", "rope/per_row", "rope/bwd"),
              "fused_sampling": ("fused_sampling",),
              "flash_attention_fwd": ("flash_fwd",),
              "flash_attention_bwd_dq": ("flash_bwd_dq",),
              "flash_attention_bwd_dkv": ("flash_bwd_dkv",)}
    kernels = []
    for name, (kname, shape, dt) in pick.items():
        match = [r for r in rows if r["kernel"] == kname
                 and tuple(r["shape"]) == shape and r["dtype"] == dt]
        errs = [r["err"] for r in rows
                if r["kernel"] in family[name]
                or r["kernel"].split("/")[0] in family[name]]
        r = match[0]
        n = sum((st or {}).get("launches", {}).get(name, 0)
                for st in (serve, train))
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
