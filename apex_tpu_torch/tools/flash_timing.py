"""Time the flash attention, LayerNorm, paged attention, fp8 Adam,
sampling, softmax, RoPE and GroupNorm kernels of one checkout of the port.

Run on a machine with an NVIDIA Hopper card, as a script:

    python3 apex_tpu_torch/tools/flash_timing.py [--root DIR] [--label NAME]
        [--cases TAG,...] [--sdpa] [--layer-norm] [--paged] [--split-keys N,...] [--fp8-adam]
        [--sampling] [--softmax] [--rope] [--group-norm] [--no-flash]
        [--nvcc] [--out DIR]

It builds the ``flash_attention`` kernel library of the package found
under ``--root`` (default: the checkout holding this script), and times
the forward, dq and dk/dv kernels at ``chip_smoke.py``'s flash-row shapes
in bf16 — BERT-Large (b 16, s 512, h 16, d 64) plain, with a key-padding
bias and with dropout 0.1, causal GQA 32/8 at d 128 with a window of
512 (b 2, s 2048), and ViT-Huge (b 32, s 257, h 16, d 80) — as device ms
per call (torch.profiler) and call ms (CUDA events, the host's launch
cost included); ``--cases bert,vit_huge`` times only the cases of
those tags.  To compare two versions
on one card, run it once per checkout in turns (a, b, b, a) in one
command.  ``--sdpa`` adds the yardstick ``scaled_dot_product_attention``:
its forward, and its backward alone (``autograd.grad`` over a retained
forward), timed between CUDA events with the host's enqueue hidden behind
a device-side sleep, and the backward's profiler device time.
``--layer-norm`` also builds the ``layer_norm`` library and times its
forward with statistics and its backward dx kernel at BERT-Large's
training shapes — 8192 x 1024 (every LayerNorm of the encoder) and 1280
x 1024 (the 16 x 80 gathered MLM rows), bf16 activations with fp32
weights (amp O2) and fp32 — beside ``F.layer_norm``'s forward, and its
backward alone (``autograd.grad`` over a retained forward, x alone
requiring a gradient: dx only), on the same inputs; and the serving
RMSNorm forward (4 x 4096 bf16, bf16 weight, no statistics) beside
``F.rms_norm``.  ``--paged`` also builds the ``paged_attention`` library
and times ``paged_attention`` on ``chip_smoke.py``'s pools at its
chunked-prefill shapes (8 rows of 128 queries over contexts of 0-872
tokens, Llama-2-7B's 32 heads at d 128, pages of 16, bf16: on bf16 and
int8 pages, and GQA 32/8), the GQA and MHA speculative verify (4 rows of
4 queries, contexts of 250-510) and the decode shapes (4 rows of
510/480/333/250 tokens: bf16, int8, fp8, GQA 32/8, fp32, and bf16 with
the serving engine's 256-page tables; one row of 4000 tokens), and at
each decode shape ``paged_decode_fused`` with RoPE as well;
``--split-keys 32,128`` adds those of at most 8 lanes at each of these
floors of the split-K kernels' split size (``_SPLIT_KEYS``; checkouts
that have one).
``--fp8-adam`` also builds the ``fp8_adam`` library and times one fp8
Adam step (``fp8_adam_kernel``, one launch) at ``chip_smoke.py``'s
BERT-Large layout (every parameter a leaf, the linear weights
transposed, 3.36e8 fp32 masters; AdamW, wd 0) and on its small leaves
(7, 300, 16384 + 300 elements and transposed leaves of 300 x 5, 512 x 64
and 1024 x 4096, wd 0.01).
``--sampling`` also builds the ``fused_sampling`` library and times
``fused_sample`` (one kernel launch) at ``chip_smoke.py``'s sampler rows:
4 x 32000 in fp32 and bf16 (greedy, temperature, top-k, top-p rows, and
every filter mixed), 8 x 128256 in fp32 and bf16, 16 x 32000 bf16 (a
verify step of 4 slots x 4 drafts), 4 x 50257 fp16 and 40 x 128256 bf16,
with its plain version (``fused_sample_reference``) beside each.
``--softmax`` also builds the ``softmax`` library and times the forward
kernel at BERT-Large's scores (16, 16, 512, 512) bf16 with a key-padding
mask and GPT's causal (4, 16, 1024, 1024) bf16, scale 0.125, beside
``torch.softmax`` on the same tensor, and the backward kernel at both
shapes beside torch's softmax backward (``_softmax_backward_data``).
``--rope`` also builds the ``rope`` library and times RoPE as the
checkout's model calls it on q and k in a packed grouped projection
(Llama-2-7B, bf16, per-row tables) at the chunked-prefill step's shape
(8 x 128 tokens) and the dense decode step's (4 x 1) — copies included,
with the kernels a call launches — the backward of the chunk's rotation
into the projection, and the one-operand backward at (1, 512, 32, 128).
``--group-norm`` also builds the ``group_norm`` library and times the
GroupNorm(+SiLU) forward (B-16) and backward (B-17, from the plain
version's statistics) as the checkout's wrappers launch them, at
(8, 64x64, 512), 32 groups, fp32 affine, in bf16 and fp32 (the cluster
route where the checkout has one), at a VAE decoder's (1, 512x512, 128)
bf16 and at the UNet widths of SD-1.5 (batch 2 at 64x64x320, 32x32x640,
16x16x1280) and SDXL (2, 128x128, 320), bf16, whose groups of 10, 20 and
40 channels take the three-pass route: device ms (torch.profiler) and
call ms (CUDA events), the byte bound (each operand once at 3.35 TB/s),
the CUDA kernels a call and the launch counts by entry; beside them
``F.silu(F.group_norm)`` on an NCHW copy of the same data, forward and
forward + backward, as the yardstick (the port never calls it).
``--no-flash`` leaves the flash library out
(neither built nor timed).
``--nvcc`` first times ``nvcc`` on ``flash_attention.cu`` alone, once with
the checkout's ``_build.NVCC_FLAGS`` and once with them less
``--split-compile``.  The record goes to ``<--out>/<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CASES = [
    # tag, b, s, h, hk, d, causal, window, key-padding bias, dropout rate
    ("bert", 16, 512, 16, 16, 64, False, None, False, 0.0),
    ("bert/pad", 16, 512, 16, 16, 64, False, None, True, 0.0),
    ("bert/drop", 16, 512, 16, 16, 64, False, None, False, 0.1),
    ("gqa/window", 2, 2048, 32, 8, 128, True, 512, False, 0.0),
    ("vit_huge", 32, 257, 16, 16, 80, False, None, False, 0.0),
]


def _profiled(torch, fn, iters=20, warmup=5):
    """(device ms, call ms) per call of ``fn``."""
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
    call = start.elapsed_time(end) / iters
    # the profiler now and then reports no kernel at all: profile again
    # rather than record 0 ms
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = sum(getattr(e, "self_device_time_total", 0)
                  for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if dev > 0:
            break
    return dev / iters / 1e3, call


def _queued(torch, fn, iters=20, warmup=5):
    """Device ms per call between CUDA events, the host's enqueue hidden
    behind a ~25 ms device-side sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _layer_norm_rows(torch, F, g):
    """``{tag: {"dx": (device ms, call ms), "torch_bwd": ...}}`` of the
    LayerNorm backward dx kernel and ``F.layer_norm``'s backward."""
    from apex_tpu_torch.ops import layer_norm as L

    dev = torch.device("cuda")
    rows = {}
    for n in (8192, 1280):
        for dt in (torch.bfloat16, torch.float32):
            h = 1024
            x = (1 + torch.randn(n, h, generator=g, device=dev)).to(dt)
            w = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
            b = 0.1 * torch.randn(h, generator=g, device=dev)
            dy = torch.randn(n, h, generator=g, device=dev).to(dt)
            _, mu, rs = L.layer_norm_fwd_kernel(x, w, b, 1e-5, False, True)
            xr = x.detach().requires_grad_()
            y = F.layer_norm(xr, (h,), w.to(dt), b.to(dt), 1e-5)
            rows[f"ln_bwd/{n}x{h}/{str(dt)[6:]}"] = dict(
                dx=_profiled(torch, lambda: L.layer_norm_bwd_dx_kernel(
                    dy, x, w, mu, rs, False), iters=50),
                torch_bwd=_profiled(torch, lambda: torch.autograd.grad(
                    y, xr, dy, retain_graph=True), iters=50))
    return rows


def _layer_norm_fwd_rows(torch, F, g):
    """``{tag: {"fwd": (device ms, call ms), "torch_fwd": ...}}`` of the
    LayerNorm forward kernel (with statistics at the training shapes,
    without at the serving RMSNorm's) and the PyTorch call."""
    from apex_tpu_torch.ops import layer_norm as L

    dev = torch.device("cuda")
    rows = {}
    for n in (8192, 1280):
        for dt in (torch.bfloat16, torch.float32):
            h = 1024
            x = (1 + torch.randn(n, h, generator=g, device=dev)).to(dt)
            w = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
            b = 0.1 * torch.randn(h, generator=g, device=dev)
            wd, bd = w.to(dt), b.to(dt)
            rows[f"ln_fwd/{n}x{h}/{str(dt)[6:]}"] = dict(
                fwd=_profiled(torch, lambda: L.layer_norm_fwd_kernel(
                    x, w, b, 1e-5, False, True), iters=50),
                torch_fwd=_profiled(torch, lambda: F.layer_norm(
                    x, (h,), wd, bd, 1e-5), iters=50))
    x = torch.randn(4, 4096, generator=g, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(
        torch.bfloat16)
    r = dict(fwd=_profiled(torch, lambda: L.layer_norm_fwd_kernel(
        x, w, None, 1e-5, True, False), iters=50))
    if hasattr(F, "rms_norm"):
        r["torch_fwd"] = _profiled(
            torch, lambda: F.rms_norm(x, (4096,), w, eps=1e-5), iters=50)
    rows["rms_fwd/4x4096/bfloat16"] = r
    return rows


_DEC = [510, 480, 333, 250]
_CHUNK = [0, 120, 250, 400, 560, 700, 812, 872]
PAGED_CASES = [
    # tag, b, s, h, hk, lengths, kv_dtype[, q dtype, table width in pages]
    ("chunk", 8, 128, 32, 32, _CHUNK, None),
    ("chunk/int8", 8, 128, 32, 32, _CHUNK, "int8"),
    ("chunk/gqa", 8, 128, 32, 8, _CHUNK, None),
    ("verify/gqa", 4, 4, 32, 8, _DEC, None),
    ("verify", 4, 4, 32, 32, _DEC, None),
    ("decode", 4, 1, 32, 32, _DEC, None),
    ("decode/int8", 4, 1, 32, 32, _DEC, "int8"),
    ("decode/fp8", 4, 1, 32, 32, _DEC, "fp8"),
    ("decode/gqa", 4, 1, 32, 8, _DEC, None),
    ("decode/fp32", 4, 1, 32, 32, _DEC, None, "float32"),
    ("decode/w256", 4, 1, 32, 32, _DEC, None, "bfloat16", 256),
    ("decode/long", 1, 1, 32, 32, [4000], None),
]


def _paged_rows(torch, g, split_keys=()):
    """``{tag: {"kernel": (device ms, call ms)[, "fused": ...]}}`` of
    ``paged_attention`` at :data:`PAGED_CASES` on ``chip_smoke.py``'s
    pools (this checkout's: each row's tokens on shuffled pages of 16, d
    128) and, at s = 1, of ``paged_decode_fused`` with RoPE on the same
    pools (the step writes the same row at every call).  Each of
    ``split_keys`` adds the rows of the cases of at most 8 lanes with the
    checkout's ``_SPLIT_KEYS`` (the split size's floor) set to it
    (``/split<n>`` tags), where the checkout has one."""
    import importlib

    sys.path.insert(1, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    PA = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    from apex_tpu_torch.ops.rope import rope_cos_sin

    dev = torch.device("cuda")
    cos_t, sin_t = rope_cos_sin(4096, 128, device=dev)
    rows = {}
    default = getattr(PA, "_SPLIT_KEYS", None)
    sweeps = [(None, "")] + [(n, f"/split{n}") for n in split_keys
                             if default is not None]
    for tag, b, s, h, hk, lengths, kv, *more in PAGED_CASES:
        dt = getattr(torch, more[0]) if more else torch.bfloat16
        width = more[1] if len(more) > 1 else None
        kp, vp, tables, lens, _ = chip_smoke._paged_pool(
            torch, g, dev, b=b, hk=hk, d=128, bs=16, lengths=lengths, s=s,
            dtype=dt, width=width)
        kw = {}
        if kv:
            kp, vp, ks, vs = PA.quantize_kv_pages(kp, vp, kv)
            kw = dict(k_scales=ks, v_scales=vs)
        q = torch.randn(b, s, h, 128, generator=g, device=dev).to(dt)
        fkw = None
        if s == 1:
            pos = lens.long()
            nk, nv = (torch.randn(b, 1, hk, 128, generator=g,
                                  device=dev).to(dt) for _ in range(2))
            fkw = dict(max_seq_len=4096, cos_b=cos_t[pos][:, None, None, :],
                       sin_b=sin_t[pos][:, None, None, :])
            if kv:
                fkw["chunk_lens"] = torch.ones(b, dtype=torch.int32,
                                               device=dev)
            pools = [t.clone() for t in (kp, vp)]
            fsc = ({"k_scales": kw["k_scales"].clone(),
                    "v_scales": kw["v_scales"].clone()} if kv else {})
        for split, suffix in sweeps:
            if split is not None and (h // hk) * s > 8:
                continue
            if split is not None:
                PA._SPLIT_KEYS = split
            r = dict(kernel=_profiled(
                torch, lambda: PA.paged_attention(q, kp, vp, tables, lens,
                                                  **kw), iters=20))
            if fkw is not None:
                r["fused"] = _profiled(torch, lambda: PA.paged_decode_fused(
                    q, nk, nv, *pools, tables, lens, **fkw, **fsc), iters=20)
            rows[f"paged/{tag}{suffix}"] = r
        if default is not None:
            PA._SPLIT_KEYS = default
    return rows


def _nvcc_seconds(_build, out_dir):
    """``{"flags": s, "no_split": s}``: seconds of one ``nvcc`` of the
    flash source with the checkout's flags, and without split compile."""
    import subprocess

    src = Path(_build.__file__).resolve().parent / "csrc" / \
        _build.SOURCES["flash_attention"]
    lib = os.path.join(out_dir, "nvcc_timing.so")
    secs = {}
    for tag in ("flags", "no_split"):
        flags = [f for f in _build.NVCC_FLAGS
                 if tag == "flags" or not f.startswith("--split-compile")]
        t0 = time.monotonic()
        subprocess.run([_build._nvcc(), *flags, "-o", lib, str(src)],
                       check=True, capture_output=True)
        secs[tag] = time.monotonic() - t0
    os.remove(lib)
    return secs


def _fp8_adam_rows(torch, g):
    """``{tag: {"step": (device ms, call ms)}}`` of the fp8 Adam kernel,
    the state after three steps."""
    import importlib

    from apex_tpu_torch.core import parameter_leaves
    from apex_tpu_torch.models import BertConfig, BertModel
    fa = importlib.import_module("apex_tpu_torch.optim.fused_adam")

    dev = torch.device("cuda")
    meta = BertModel(BertConfig.bert_large(dtype=torch.bfloat16, remat=True),
                     device="meta")
    small = [fa.Leaf(7), fa.Leaf(300), fa.Leaf(16384 + 300),
             fa.Leaf(300 * 5, (300, 5)), fa.Leaf(512 * 64, (512, 64)),
             fa.Leaf(1024 * 4096, (1024, 4096))]
    rows = {}
    for tag, leaves, wd in (
            ("fp8_adam/bert_large", [lf for _, lf in parameter_leaves(meta)],
             0.0),
            ("fp8_adam/small", small, 0.01)):
        lay = fa.Fp8Layout(leaves)
        opt = fa.fused_adam(1e-3, weight_decay=wd,
                            moment_format="fp8_block_scaled")
        p = torch.randn(lay.numel, generator=g, device=dev)
        st = opt.init([p], [leaves])
        for _ in range(3):
            gr = 1e-3 * torch.randn(lay.numel, generator=g, device=dev)
            opt.step([gr], st, [p], implementation="kernel")
        sc = torch.tensor([1e-3, 0.1, 0.001], device=dev)
        m, v = st.exp_avg[0], st.exp_avg_sq[0]
        hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
                  adam_w_mode=True)
        rows[tag] = dict(step=_profiled(
            torch, lambda: fa.fp8_adam_kernel(gr, p, m, v, lay, sc, None,
                                              **hp), iters=10))
        del p, st, gr, m, v
        torch.cuda.empty_cache()
    return rows


_G4 = [[(0.0, 0, 0.0), (0.8, 0, 0.0), (1.0, 40, 0.0), (0.9, 0, 0.9)],
       [(0.7, 50, 0.8), (1.2, 5, 0.5), (1.0, 0, 0.0), (0.0, 0, 0.0)]]
_G8 = [(0.0, 0, 0.0), (0.0, 0, 0.0), (1.0, 0, 0.0), (0.6, 0, 0.0),
       (1.0, 100, 0.0), (0.8, 0, 0.95), (0.7, 40, 0.9), (1.1, 1000, 0.5)]
SAMPLING_CASES = [
    # tag, rows, vocab, dtype, (temperature, top_k, top_p) a row
    ("4x32000/fp32/grid0", 4, 32000, "float32", _G4[0]),
    ("4x32000/fp32/grid1", 4, 32000, "float32", _G4[1]),
    ("4x32000/bf16/grid0", 4, 32000, "bfloat16", _G4[0]),
    ("4x32000/bf16/grid1", 4, 32000, "bfloat16", _G4[1]),
    ("8x128256/fp32", 8, 128256, "float32", _G8),
    ("8x128256/bf16", 8, 128256, "bfloat16", _G8),
    ("16x32000/bf16", 16, 32000, "bfloat16",
     [(0.8, 40, 0.9), (1.0, 0, 0.0), (0.0, 0, 0.0), (0.7, 0, 0.95)] * 4),
    ("4x50257/fp16", 4, 50257, "float16", _G4[0]),
    ("40x128256/bf16", 40, 128256, "bfloat16", _G8 * 5),
]


def _sampling_rows(torch, g):
    """``{tag: {"kernel": (device ms, call ms), "plain": ...,
    "tokens": [...]}}`` of ``fused_sample`` at :data:`SAMPLING_CASES`."""
    from apex_tpu_torch.ops import fused_sampling as fs

    dev = torch.device("cuda")
    rows_out = {}
    for tag, rows, vocab, dt, cfgs in SAMPLING_CASES:
        logits = (2.0 * torch.randn(rows, vocab, generator=g, device=dev)).to(
            getattr(torch, dt))
        t, k, p = (torch.tensor(c, device=dev) for c in zip(*cfgs))
        k = k.int()
        keys = fs.split(torch.stack([fs.prng_key(i, dev)
                                     for i in range(rows)]))[:, 0]
        rows_out[f"sampling/{tag}"] = dict(
            kernel=_profiled(torch, lambda: fs.fused_sample(
                logits, keys, t, k, p), iters=20),
            plain=_profiled(torch, lambda: fs.fused_sample_reference(
                logits, keys, t, k, p, vocab), iters=5),
            tokens=fs.fused_sample(logits, keys, t, k, p).tolist())
    return rows_out


def _softmax_rows(torch, g):
    """``{tag: {"fwd" | "bwd": (device ms, call ms), "torch_softmax" |
    "torch_softmax_bwd": ...}}`` of the softmax forward and backward
    kernels at phase 1's two shapes (the backward from the plain
    forward's y, no mask: the widths where it takes none)."""
    from apex_tpu_torch.ops import softmax as S

    dev = torch.device("cuda")
    rows_out = {}
    for tag, shape, mshape, causal in (
            ("bert", (16, 16, 512, 512), (16, 1, 1, 512), False),
            ("gpt_causal", (4, 16, 1024, 1024), None, True)):
        x = (3 * torch.randn(shape, generator=g, device=dev)).to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        m = None if mshape is None else torch.rand(
            mshape, generator=g, device=dev) < 0.3
        y = S.scale_mask_softmax_reference(x, m, 0.125, causal)
        rows_out[f"softmax_fwd/{tag}"] = dict(
            fwd=_profiled(torch, lambda: S.softmax_fwd_kernel(
                x, m, 0.125, causal), iters=50),
            torch_softmax=_profiled(torch, lambda: torch.softmax(x, -1),
                                    iters=50))
        rows_out[f"softmax_bwd/{tag}"] = dict(
            bwd=_profiled(torch, lambda: S.softmax_bwd_kernel(
                dy, y, 0.125), iters=50),
            torch_softmax_bwd=_profiled(
                torch, lambda: torch.ops.aten._softmax_backward_data(
                    dy, y, -1, torch.bfloat16), iters=50))
        del x, dy, y
        torch.cuda.empty_cache()
    return rows_out


def _group_norm_rows(torch, F, g):
    """``{tag: {"fwd" | "bwd": (device ms, call ms), "fwd_split" |
    "bwd_split": CUDA kernels a call and device ms by kernel
    (:func:`_kernel_split`), "fwd_launches" | "bwd_launches":
    launches by entry, "library_fwd" | "library_fwd_bwd": ...}}`` of the
    GroupNorm kernels at the main shape in bf16 and fp32, at a VAE
    decoder's bf16 shape and at SD-1.5's and SDXL's UNet widths."""
    import importlib

    from apex_tpu_torch import _build

    GN = importlib.import_module("apex_tpu_torch.ops.group_norm")
    dev = torch.device("cuda")
    rows_out = {}
    for tag, shape, dt in (("main", (8, 64, 64, 512), torch.bfloat16),
                           ("main", (8, 64, 64, 512), torch.float32),
                           ("vae", (1, 512, 512, 128), torch.bfloat16),
                           ("sd15_320", (2, 64, 64, 320), torch.bfloat16),
                           ("sd15_640", (2, 32, 32, 640), torch.bfloat16),
                           ("sd15_1280", (2, 16, 16, 1280), torch.bfloat16),
                           ("sdxl_320", (2, 128, 128, 320), torch.bfloat16)):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        dy = torch.randn(shape, generator=g, device=dev).to(dt)
        w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        x3, dy3 = x.view(shape[0], -1, c), dy.view(shape[0], -1, c)
        _, mean, rstd = GN.group_norm_fwd_reference(x3, w, b, 32, 1e-5, True)

        def fwd():
            return GN.group_norm_fwd_kernel(x3, w, b, 32, 1e-5, True)

        def bwd():
            return GN.group_norm_bwd_kernel(dy3, x3, w, b, mean, rstd, 32,
                                            True)
        launches = {}
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            _build.reset_launches()
            fn()
            launches[name] = {k: v for k, v in _build.launches.items() if v}
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        dy_nchw = dy.permute(0, 3, 1, 2).contiguous()
        wl, bl = w.to(dt), b.to(dt)

        def lib_fwd():
            return F.silu(F.group_norm(x_nchw, 32, wl, bl, 1e-5))

        def lib_fwd_bwd():
            xr, wr, br = (t.detach().requires_grad_()
                          for t in (x_nchw, wl, bl))
            out = F.silu(F.group_norm(xr, 32, wr, br, 1e-5))
            return torch.autograd.grad(out, (xr, wr, br), dy_nchw)
        # each operand read or written once: x and y (dy, x and dx), the
        # fp32 affine (and dγ, dβ) and the statistics
        n_el, isz, stat = x.numel(), x.element_size(), 2 * shape[0] * 32 * 4
        rows_out[f"group_norm/{tag}/{str(dt)[6:]}"] = dict(
            shape=list(x3.shape),
            bound_fwd=(2 * n_el * isz + 2 * c * 4 + stat) / 3.35e9,
            bound_bwd=(3 * n_el * isz + 4 * c * 4 + stat) / 3.35e9,
            fwd=_profiled(torch, fwd, iters=30),
            bwd=_profiled(torch, bwd, iters=30),
            fwd_split=_kernel_split(torch, fwd, "gn_"),
            bwd_split=_kernel_split(torch, bwd, "gn_"),
            fwd_launches=launches["fwd"], bwd_launches=launches["bwd"],
            library_fwd=_profiled(torch, lib_fwd, iters=30),
            library_fwd_bwd=_profiled(torch, lib_fwd_bwd, iters=30))
        del x, dy, x_nchw, dy_nchw
        torch.cuda.empty_cache()
    return rows_out


def _kernel_split(torch, fn, pattern, iters=20):
    """Per call of ``fn`` (torch.profiler): device ms of the kernels whose
    name contains ``pattern``, of the others, of each kernel by name (its
    first 60 characters), and the kernels launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    mine = other = count = 0
    by_kernel = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", 0)
        mine += us if pattern in e.key else 0
        other += 0 if pattern in e.key else us
        count += e.count
        name = e.key[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + us / iters / 1e3
    return dict(match_ms=mine / iters / 1e3, other_ms=other / iters / 1e3,
                kernels=count / iters, by_kernel=by_kernel)


def _rope_rows(torch, g):
    """``{tag: {"fwd" | "bwd": (device ms, call ms), "fwd_split" |
    "bwd_split": {...}}}`` of RoPE as the checkout's model calls it, on q
    and k viewed in a packed grouped qkv projection (Llama-2-7B: 32
    heads, d 128, bf16, per-row tables): ``_rope_qk`` where the checkout
    has it, else q reshaped (a copy) and ``fused_rope`` on each — at the
    chunked-prefill step's shape (8 x 128) and the dense decode step's (4
    x 1); the backward of that forward into the projection at the chunk
    shape; and the one-operand ``fused_rope`` backward at (1, 512, 32,
    128).  The splits (:func:`_kernel_split`) part the device time into
    the RoPE kernels' (a step's ``rope`` group is 32 times it) and the
    rest (the copies), with the kernels a call launches."""
    from apex_tpu_torch.ops import rope as R

    dev = torch.device("cuda")
    cos_t, sin_t = R.rope_cos_sin(4096, 128, device=dev)
    h, d = 32, 128

    def rotate(q5, k, c, s):
        if hasattr(R, "_rope_qk"):
            return R._rope_qk(q5, k, c, s)
        b, n = k.shape[:2]
        return (R.fused_rope(q5.reshape(b, n, h, d), c, s),
                R.fused_rope(k, c, s))

    rows_out = {}
    for tag, b, n in (("chunk", 8, 128), ("decode", 4, 1)):
        qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev).to(
            torch.bfloat16)
        gv = qkv.view(b, n, h, 3, d)
        pos = torch.randint(0, 4096 - n, (b, 1), generator=g,
                            device=dev) + torch.arange(n, device=dev)
        c, s = cos_t[pos], sin_t[pos]
        r = dict(fwd=_profiled(torch, lambda: rotate(
            gv[..., :1, :], gv[..., 1, :], c, s), iters=50),
            fwd_split=_kernel_split(torch, lambda: rotate(
                gv[..., :1, :], gv[..., 1, :], c, s), "rope"))
        if tag == "chunk":
            leaf = qkv.detach().requires_grad_()
            lv = leaf.view(b, n, h, 3, d)
            outs = rotate(lv[..., :1, :], lv[..., 1, :], c, s)
            grads = tuple(torch.randn(o.shape, generator=g, device=dev).to(
                torch.bfloat16) for o in outs)

            def bwd():
                return torch.autograd.grad(outs, leaf, grads,
                                           retain_graph=True)
            r["bwd"] = _profiled(torch, bwd, iters=50)
            r["bwd_split"] = _kernel_split(torch, bwd, "rope")
        rows_out[f"rope/qk_{tag}"] = r
    x = torch.randn(1, 512, h, d, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    xr = x.requires_grad_()
    y = R.fused_rope(xr, cos_t[:512], sin_t[:512])

    def bwd1():
        return torch.autograd.grad(y, xr, dy, retain_graph=True)
    rows_out["rope/bwd"] = dict(bwd=_profiled(torch, bwd1, iters=50),
                                bwd_split=_kernel_split(torch, bwd1, "rope"))
    return rows_out


def main(argv=None):
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--label", default="change")
    ap.add_argument("--cases", default="",
                    help="comma-separated flash case tags to time "
                         "(default: all)")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--layer-norm", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--split-keys", default="",
                    help="comma-separated split sizes (keys) to time the "
                         "split-K paged rows at besides the default")
    ap.add_argument("--fp8-adam", action="store_true")
    ap.add_argument("--sampling", action="store_true")
    ap.add_argument("--softmax", action="store_true")
    ap.add_argument("--rope", action="store_true")
    ap.add_argument("--group-norm", action="store_true")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--nvcc", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "flash_timing"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_timing: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as A

    _build.SOURCES = {} if args.no_flash else {
        "flash_attention": "flash_attention.cu"}
    if args.layer_norm:
        _build.SOURCES["layer_norm"] = "layer_norm.cu"
    if args.paged:
        _build.SOURCES["paged_attention"] = "paged_attention.cu"
    if args.fp8_adam:
        _build.SOURCES["fp8_adam"] = "fp8_adam.cu"
    if args.sampling:
        _build.SOURCES["fused_sampling"] = "fused_sampling.cu"
    if args.softmax:
        _build.SOURCES["softmax"] = "softmax.cu"
    if args.rope:
        _build.SOURCES["rope"] = "rope.cu"
    if args.group_norm:
        _build.SOURCES["group_norm"] = "group_norm.cu"
    os.makedirs(args.out, exist_ok=True)
    out = dict(label=args.label, root=os.path.abspath(args.root),
               card=torch.cuda.get_device_name(0), rows={})
    if args.nvcc:
        out["nvcc_s"] = _nvcc_seconds(_build, args.out)
        print(args.label, "nvcc_s", json.dumps(out["nvcc_s"]), flush=True)
    t0 = time.monotonic()
    _build.build_all()
    out["build_s"] = time.monotonic() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16
    wanted = set(filter(None, args.cases.split(",")))
    for tag, b, s, h, hk, d, causal, window, has_bias, rate in (
            [] if args.no_flash else
            [c for c in CASES if not wanted or c[0] in wanted]):
        q, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, s, hk, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        bias = None
        if has_bias:
            lens = torch.randint(s // 2, s + 1, (b,), generator=g,
                                 device=dev)
            bias = A.mask_to_bias(torch.arange(s, device=dev)[None, :]
                                  >= lens[:, None]).view(b, 1, 1, s)
        fa = (bias, d ** -0.5, causal, window, rate, 20240613)
        o, lse = A.flash_fwd_reference(q, k, v, *fa)
        bw = (q, k, v, bias, do, lse, A.attention_delta(do, o)) + fa[1:]
        r = dict(fwd=_profiled(torch, lambda: A.flash_fwd_kernel(q, k, v,
                                                                 *fa)),
                 dq=_profiled(torch, lambda: A.flash_bwd_dq_kernel(*bw)),
                 dkv=_profiled(torch, lambda: A.flash_bwd_dkv_kernel(*bw)))
        if hasattr(A, "flash_route"):    # checkouts that report the route
            r["route"] = {kn: A.flash_route(kn, dt, d)
                          for kn in ("fwd", "dq", "dkv")}
        if args.sdpa:
            qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v, do))
            mask = None
            if bias is not None:
                mask = bias.to(dt)
            elif window:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] <= i[:, None]) & (
                    i[None, :] > i[:, None] - window)
            kw = dict(attn_mask=mask, dropout_p=rate,
                      is_causal=causal and mask is None, enable_gqa=hk != h)
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
            kept = F.scaled_dot_product_attention(qg, kg, vg, **kw)

            def bwd():
                return torch.autograd.grad(kept, (qg, kg, vg), dot,
                                           retain_graph=True)
            r["sdpa_fwd_queued"] = _queued(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                              **kw))
            r["sdpa_bwd_queued"] = _queued(torch, bwd)
            r["sdpa_bwd_profiled"] = _profiled(torch, bwd)
        out["rows"][tag] = r
        print(args.label, tag, json.dumps(r), flush=True)
    more = []
    if args.layer_norm:
        more += [_layer_norm_fwd_rows, _layer_norm_rows]
    if args.paged:
        splits = [int(x) for x in args.split_keys.split(",") if x]
        more.append(lambda torch, F, g: _paged_rows(torch, g, splits))
    if args.fp8_adam:
        more.append(lambda torch, F, g: _fp8_adam_rows(torch, g))
    if args.sampling:
        more.append(lambda torch, F, g: _sampling_rows(torch, g))
    if args.softmax:
        more.append(lambda torch, F, g: _softmax_rows(torch, g))
    if args.rope:
        more.append(lambda torch, F, g: _rope_rows(torch, g))
    if args.group_norm:
        more.append(_group_norm_rows)
    for rows_of in more:
        for tag, r in rows_of(torch, F, g).items():
            out["rows"][tag] = r
            print(args.label, tag, json.dumps(r), flush=True)
    with open(os.path.join(args.out, f"{args.label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
