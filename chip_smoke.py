#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py                # all phases
    python3 chip_smoke.py --kernels-only # build + phase 1 only
    python3 chip_smoke.py --profile      # + device-time breakdown of decode

It builds the port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``,
``sm_90a``) and then runs three phases; any failure exits non-zero.

1. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (Llama-2-7B width), with times: the kernel, its
   plain version, the one PyTorch call computing the same function where
   there is one (a yardstick only), and the bound — the larger of bytes
   over 3.35 TB/s and operations over the card's peak rate.
2. Engine identity at full width and depth 2 (fp32, TF32 off): greedy
   ``InferenceServer`` results equal ``generate()``; sampled requests
   equal themselves on a rerun with the same seeds.
3. The slice: Llama-2-7B at full depth in bf16 with random weights from a
   seeded generator, served by ``InferenceServer`` (4 slots, buckets
   32/128/512) for 8 requests; every kernel of the path must launch.

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
# H100 SXM INT32: 64 lanes per SM x 132 SMs x 1.98 GHz, counted as the
# fp32 rate is (a multiply-add as two operations)
INT32_OPS_PER_S = 33.5e12
VOCAB = 32000

KERNELS = {
    "layer_norm": dict(source="apex_tpu_torch/csrc/layer_norm.cu",
                       replaces="apex_tpu/ops/layer_norm.py:152"),
    "rope": dict(source="apex_tpu_torch/csrc/rope.cu",
                 replaces="apex_tpu/ops/rope.py:83"),
    "fused_sampling": dict(source="apex_tpu_torch/csrc/fused_sampling.cu",
                           replaces="apex_tpu/ops/fused_sampling.py:246"),
}


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


def bound(nbytes, ops, int_ops=0):
    """Least time (ms) for the work, and what bounds it: ``nbytes`` over
    the memory rate against ``ops`` fp32 operations and ``int_ops``
    int32 operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp_ok(torch, got, ref):
    """|got - ref| within one bf16 ulp of ref, elementwise."""
    r = ref.float().abs()
    ulp = torch.where(r > 0, torch.exp2(torch.floor(torch.log2(
        r.clamp(min=1e-30))) - 7), torch.full_like(r, 1e-30))
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


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
               ops, lib, tol, int_ops=0):
        """``kern`` / ``plain`` / ``lib``: functions to time (lib may be
        None); times are device ms per call, call ms beside them."""
        bms, by = bound(nbytes, ops, int_ops)
        iters = 20 if kernel == "fused_sampling" else 50
        t_k, t_p = timed(torch, kern, iters), timed(torch, plain, iters)
        t_l = None if lib is None else timed(torch, lib, iters)
        row = dict(kernel=kernel, shape=shape, dtype=str(dtype), err=err,
                   passed=passed, ms=t_k[0], call_ms=t_k[1],
                   plain_ms=t_p[0], plain_call_ms=t_p[1],
                   library_ms=None if t_l is None else t_l[0],
                   library_call_ms=None if t_l is None else t_l[1],
                   bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
                   int_ops=int_ops, tolerance=tol)
        rows_out.append(row)
        lib_txt = "-" if t_l is None else f"{t_l[0]:.5f}/{t_l[1]:.4f}"
        log(f"  {kernel:15s} {str(shape):18s} {str(dtype)[6:]:9s} "
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
    ok &= all(launches[n] > 0 for n in KERNELS)
    del model, one, eng, srv
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
                    help="also profile steady decode steps in phase 3")
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
    ok = phase_kernels(torch, rows)
    log(f"phase 1 {'passed' if ok else 'FAILED'}")
    stats = None
    if ok and not args.kernels_only:
        ok = phase_identity(torch)
        log(f"phase 2 {'passed' if ok else 'FAILED'}")
        if ok:
            ok, stats = phase_serve(torch, args.profile)
            log(f"phase 3 {'passed' if ok else 'FAILED'}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernel_rows=rows, serve=stats), f,
                  indent=1)
    if not ok:
        log("chip_smoke: FAILED")
        return 1

    # one row per kernel at its main-path decode shape
    pick = {"layer_norm": ("rms_norm", (4, 4096), "torch.bfloat16"),
            "rope": ("rope/per_row", (4, 1, 32, 128), "torch.bfloat16"),
            "fused_sampling": ("fused_sampling", (4, 32000),
                               "torch.bfloat16")}
    kernels = []
    for name, (kname, shape, dt) in pick.items():
        match = [r for r in rows if r["kernel"] == kname
                 and tuple(r["shape"]) == shape and r["dtype"] == dt]
        errs = [r["err"] for r in rows
                if r["kernel"].split("/")[0] in
                (("rms_norm", "layer_norm") if name == "layer_norm"
                 else (name,))]
        r = match[0]
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"],
            launches=(stats["launches"][name] if stats else 0),
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
