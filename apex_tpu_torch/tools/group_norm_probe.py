"""Take the GroupNorm cluster kernels apart on the card: where a slab round
goes, and how the slab's geometry moves the device time.

Run on a machine with an NVIDIA Hopper card, from the root of a checkout:

    python3 apex_tpu_torch/tools/group_norm_probe.py [--out DIR]

1. Phase trace.  ``csrc/group_norm.cu`` is built once more with its
   ``GN_MARK`` phase marks defined (thread 0 of every CTA writes
   ``clock64()`` at the phase boundaries of each slab round into a device
   array), under ``build/group_norm_probe``, and run at (8, 64x64, 512),
   32 groups, SiLU, fp32 affine, bf16 and fp32, forward and backward, on
   the plan ``cluster_plan`` picks.  Per direction: mean cycles of each
   phase a round, rounds a CTA, the wait for the staged slab by round,
   and the cycles a CTA runs.  Forward phases: round start to the staged slab
   (wait), the thread statistics and the warps' trees, the cross-warp
   tree, the cluster barrier, the ranks' merge, normalise and store.
   Backward: wait, pass 1 (dy' and xhat), the per-channel trees, the
   cluster barrier, the ranks' gather and c1 / c2, dx, the ticket and
   dgamma / dbeta.
2. Plan sweep.  Device ms (torch.profiler) of the uninstrumented kernels
   at the same shape on other slab geometries (span, cluster size; as
   many clusters as the card runs at once), beside the three-pass route,
   with the largest difference from the plain version.

The record goes to ``<--out>/group_norm_probe.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROUNDS = 8          # rounds traced a CTA
MARKS = 9           # clock64 slots a round (the last holds the SM id)
MAX_CTAS = 4096

FWD_PHASES = ["wait", "stats_and_warp_trees", "cross_warp_tree",
              "cluster_barrier", "rank_merge", "normalise_store", "end_sync"]
BWD_PHASES = ["wait", "pass1", "channel_trees", "cluster_barrier",
              "rank_gather_c1_c2", "dx", "ticket_dgamma_dbeta"]
# the trace buffer and the marks (thread 0 of a CTA, the first ROUNDS
# rounds; mark 0 also records the SM), then the kernels' source
HEAD = """
__device__ long long gn_trace[MAX_CTAS * ROUNDS * MARKS];
#define GN_MARK(i) do { if (threadIdx.x == 0 && it < ROUNDS) { \\
    long long* m_ = gn_trace + ((size_t)blockIdx.x * ROUNDS + it) * MARKS; \\
    m_[(i)] = clock64(); \\
    if ((i) == 0) { unsigned sm_; \\
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_)); \\
      m_[MARKS - 1] = sm_; } } } while (0)
#include "SOURCE"
extern "C" int gn_trace_read(void* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, gn_trace, n * sizeof(long long));
}
extern "C" int gn_trace_clear() {
  static long long z[MAX_CTAS * ROUNDS * MARKS];
  return (int)cudaMemcpyToSymbol(gn_trace, z, sizeof(z));
}
"""
# slab geometries (span, cluster size) of the sweep
SWEEP = {
    ("bfloat16", False): [(16, 2), (32, 4), (64, 8)],
    ("bfloat16", True): [(32, 8), (16, 4), (64, 16)],
    ("float32", False): [(16, 4), (32, 8)],
    ("float32", True): [(16, 8), (32, 16)],
}


def build_instrumented(_build, root: Path) -> Path:
    """A library of ``csrc/group_norm.cu`` with its ``GN_MARK`` phase
    marks defined, built under ``build/group_norm_probe``."""
    out_dir = root / "build" / "group_norm_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = root / "apex_tpu_torch" / "csrc" / "group_norm.cu"
    cu = out_dir / "group_norm_probe.cu"
    lib = out_dir / "libgroup_norm_probe.so"
    text = HEAD
    for name, v in (("MAX_CTAS", MAX_CTAS), ("ROUNDS", ROUNDS),
                    ("MARKS", MARKS), ("SOURCE", src)):
        text = text.replace(name, str(v))
    cu.write_text(text)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    return lib


def _use_library(_build, lib):
    """Route the group_norm wrappers to library ``lib``."""
    _build._paths["group_norm"] = Path(lib)
    _build._libs.pop("group_norm", None)
    for key in [k for k in _build._fns if k[0] == "group_norm"]:
        del _build._fns[key]


def _device_ms(torch, fn, iters=30):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0:
            break
    return us / iters / 1e3


def _inputs(torch, dt, g):
    dev = torch.device("cuda")
    x = torch.randn(8, 4096, 512, generator=g, device=dev).to(dt)
    dy = torch.randn(8, 4096, 512, generator=g, device=dev).to(dt)
    w = 1 + 0.2 * torch.randn(512, generator=g, device=dev)
    b = 0.1 * torch.randn(512, generator=g, device=dev)
    return x, dy, w, b


def trace(torch, GN, lib, dt, backward, g):
    """Mean cycles a phase a round of one call on the planned route."""
    x, dy, w, b = _inputs(torch, dt, g)
    y, mean, rstd = GN.group_norm_fwd_reference(x, w, b, 32, 1e-5, True)
    if backward:
        def call():
            return GN.group_norm_bwd_kernel(dy, x, w, b, mean, rstd, 32, True)
    else:
        def call():
            return GN.group_norm_fwd_kernel(x, w, b, 32, 1e-5, True)
    plan = GN._route(x, 32, backward)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.gn_trace_clear()
    call()
    torch.cuda.synchronize()
    ctas = plan.clusters * plan.cluster
    n = ctas * ROUNDS * MARKS
    buf = (ctypes.c_longlong * n)()
    if lib.gn_trace_read(ctypes.addressof(buf), ctypes.c_longlong(n)):
        raise RuntimeError("reading the trace failed")
    a = torch.tensor(list(buf), dtype=torch.int64).view(ctas, ROUNDS, MARKS)
    done = a[:, :, 7] > 0
    d = (a[:, :, 1:8] - a[:, :, 0:7]).double()
    names = BWD_PHASES if backward else FWD_PHASES
    out = {nm: float(d[..., i][done].mean()) for i, nm in enumerate(names)}
    out["round"] = float((a[:, :, 7] - a[:, :, 0]).double()[done].mean())
    out["rounds_per_cta"] = float(done.sum(1).double().mean())
    wait = d[..., 0]
    out["wait_by_round"] = [float(wait[:, j][done[:, j]].mean())
                            for j in range(ROUNDS) if done[:, j].any()]
    last = torch.where(done, a[:, :, 7], torch.zeros_like(a[:, :, 7]))
    out["cta_cycles"] = float((last.max(1).values - a[:, 0, 0]).double()
                              .mean())
    out["plan"] = list(plan)
    return out


def sweep(torch, GN, dt, backward, g):
    """Device ms of each geometry of :data:`SWEEP`, and the three-pass
    route's, with the largest difference from the plain version."""
    dev = torch.device("cuda")
    x, dy, w, b = _inputs(torch, dt, g)
    y0, m0, r0 = GN.group_norm_fwd_reference(x, w, b, 32, 1e-5, True)
    ref = GN.group_norm_bwd_reference(dy, x, w, b, m0, r0, 32, True)
    if backward:
        def call():
            return GN.group_norm_bwd_kernel(dy, x, w, b, m0, r0, 32, True)

        def err(out):
            return float((out[0].float() - ref[0].float()).abs().max())
    else:
        def call():
            return GN.group_norm_fwd_kernel(x, w, b, 32, 1e-5, True)

        def err(out):
            return float((out[0].float() - y0.float()).abs().max())
    cap = GN._capacity(dev, dt, backward)
    route = GN._route
    rows = {}
    try:
        GN._route = lambda *a: None
        rows["three_pass"] = dict(ms=_device_ms(torch, call), err=err(call()))
        for span, cl in SWEEP[(str(dt)[6:], backward)]:
            plan = GN.ClusterPlan(span, cl, min(8 * 512 // span, cap[cl]))
            GN._route = lambda *a, plan=plan: plan
            rows[f"span {span}, cluster {cl}"] = dict(
                ms=_device_ms(torch, call), err=err(call()),
                clusters=plan.clusters)
    finally:
        GN._route = route
    return rows


def main(argv=None):
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "group_norm_probe"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("group_norm_probe: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import _build

    GN = importlib.import_module("apex_tpu_torch.ops.group_norm")
    _build.SOURCES = {"group_norm": "group_norm.cu"}
    _build.build_all()
    plain_lib = _build._paths["group_norm"]
    lib_path = build_instrumented(_build, here)
    lib = ctypes.CDLL(str(lib_path))
    lib.gn_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    g = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = dict(card=card, trace={}, sweep={})
    print(card, flush=True)
    for dt in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            tag = f"{str(dt)[6:]} {'bwd' if backward else 'fwd'}"
            _use_library(_build, lib_path)
            out["trace"][tag] = trace(torch, GN, lib, dt, backward, g)
            print("trace", tag, json.dumps(out["trace"][tag]), flush=True)
            _use_library(_build, plain_lib)
            out["sweep"][tag] = sweep(torch, GN, dt, backward, g)
            print("sweep", tag, json.dumps(out["sweep"][tag]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "group_norm_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
