"""Take the softmax forward kernel apart on the card: where its time goes.

Run on a machine with an NVIDIA Hopper card, as a script:

    python3 apex_tpu_torch/tools/softmax_probe.py [--root DIR] [--out DIR]

It builds variants of the ``softmax`` library of the checkout under
``--root`` (default: the checkout holding this script), each differing
from ``csrc/softmax.cu`` in one place, and times the forward of each at
``chip_smoke.py``'s two shapes — BERT-Large's scores (16, 16, 512, 512)
bf16 with a key-padding mask and GPT's causal (4, 16, 1024, 1024) bf16,
scale 0.125 — as device ms per call (torch.profiler) and ms per call
between CUDA events with the host's enqueue hidden, in turns (every
variant, then every variant again in reverse order):

- ``kernel``: the source as it is;
- ``copy``: each row stored as loaded, no arithmetic (the data movement);
- ``no_store``: the arithmetic, stores skipped;
- ``no_ring``: rows loaded straight from device memory, not through the
  warp's ring of shared-memory slots;
- ``no_mask``: the per-element mask and causal test left out;
- ``kill_mask``: the test as one bit mask built once a row;
- ``or_mask``: the test without short-circuit, the causal limit once a row.

``copy``, ``no_store`` and ``no_mask`` compute something else and are
timing probes only; the others are checked against the plain version
(one bf16 ulp) before they are timed.  The record goes to
``<--out>/softmax_probe.json``.

``--backward`` takes the backward apart instead, at the same shapes (dx
from the plain forward's y, no mask), every variant equal to the kernel
as it is bit for bit (``softmax_probe_bwd.json``):

- ``kernel``: the source as it is (three ring slots a warp where a slot
  is under 8 KB);
- ``slots2`` / ``slots4``: two or four slots a warp;
- ``no_ring``: rows loaded straight from device memory;
- ``runs``: each warp a contiguous run of rows, as in the forward, in
  place of rows dealt out in turn;
- ``cs_store``: dx stored with the streaming hint (``__stcs``).

A variant the compiler refuses is reported and left out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_TEST = ("        if (((mb >> (c * VEC + t)) & 1u) || (mi.causal && e0 + t > q + qoff))\n"
         "          val = kNeg;")
_HEAD = "  const int qoff = sk - mi.sq;\n  float mx = -INFINITY;"
_STORE = "      store_vec<T, VEC>(yr + e0, &v[c * VEC]);"
_RING_WAIT = ("      apex::hopper::mbar_wait(&bar[s], (uint32_t)(i / kRing) & 1u);\n"
              "      const unsigned char* row = slots + s * kSlot;")
_KILL_HEAD = """  const int qoff = sk - mi.sq;
  uint32_t kill = mb;
  if (mi.causal) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int n = min(max(q + qoff - (c * 32 + lane) * VEC + 1, 0), VEC);
      kill |= ((((1u << VEC) - 1u) >> n) << n) << (c * VEC);
    }
  }
  float mx = -INFINITY;"""
_COPY = """  if (sk > 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e0 = (c * 32 + lane) * VEC;
      if (e0 < sk) store_vec<T, VEC>(yr + e0, &v[c * VEC]);
    }
    return;
  }
""" + _HEAD
#: variant -> (replacements, computes the function)
VARIANTS = {
    "kernel": ([], True),
    "copy": ([(_HEAD, _COPY)], False),
    "no_store": ([(_STORE, "      if (v[c * VEC] == 1234.5f) " + _STORE.strip())],
                 False),
    "no_ring": ([("  if (VEC > 1 && lane == 0) {\n    for (int i = 0; i < kRing - 1",
                  "  if (false) {\n    for (int i = 0; i < kRing - 1"),
                 ("      if (lane == 0 && ahead < r1) {", "      if (false) {"),
                 (_RING_WAIT, "      const unsigned char* row =\n"
                  "          reinterpret_cast<const unsigned char*>(x + (size_t)r * sk);")],
                True),
    "no_mask": ([(_TEST, "")], False),
    "kill_mask": ([(_HEAD, _KILL_HEAD),
                   (_TEST, "        if ((kill >> (c * VEC + t)) & 1u) val = kNeg;")],
                  True),
    "or_mask": ([(_HEAD, "  const int lim = mi.causal ? q + (sk - mi.sq) : 0x7fffffff;\n"
                  "  float mx = -INFINITY;"),
                 (_TEST, "        if (((mb >> (c * VEC + t)) & 1u) | (e0 + t > lim)) "
                  "val = kNeg;")],
                True),
}


_BWD_RING = ("    if constexpr (VEC > 1) {\n"
             "      // the slot of the warp's previous row is free once every lane has\n")
_BWD_ROW = "// dx of one row: a lane's elements"
_BWD_STORE = "      store_vec<T, VEC>(dxr + e0, d);"
_CS_STORE = """template <typename T, int VEC>
__device__ __forceinline__ void store_vec_cs(T* p, const float* in) {
  if constexpr (VEC == 1) {
    p[0] = apex::from_f<T>(in[0]);
  } else {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) t[i] = apex::from_f<T>(in[i]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
}

"""
#: backward variant -> (replacements, computes the function)
BWD_VARIANTS = {
    "kernel": ([], True),
    "slots2": ([("constexpr int kSmallSlots = 3;",
                 "constexpr int kSmallSlots = 2;")], True),
    "slots4": ([("constexpr int kSmallSlots = 3;",
                 "constexpr int kSmallSlots = 4;")], True),
    "no_ring": ([("  if (VEC > 1 && lane == 0)\n    for (int k = 0; k < kSlots - 1",
                  "  if (false)\n    for (int k = 0; k < kSlots - 1"),
                 (_BWD_RING, _BWD_RING.replace("VEC > 1", "false"))], True),
    "runs": ([("  const int stride = (int)warps;  // rows dealt out in turn",
               "  const int stride = 1;")], True),
    "cs_store": ([(_BWD_ROW, _CS_STORE + _BWD_ROW),
                  (_BWD_STORE, _BWD_STORE.replace("store_vec", "store_vec_cs"))],
                 True),
}


def _build_variants(_build, root, out_dir, variants):
    """Compile every variant (all ``nvcc`` at once); returns their paths."""
    csrc = Path(root) / "apex_tpu_torch" / "csrc"
    src = (csrc / "softmax.cu").read_text()
    procs = {}
    for name, (subs, _) in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old[:50]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"softmax_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libsoftmax_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            # a variant the compiler refuses is reported and left out
            print(f"nvcc failed for {name}:\n{log[-3000:]}", flush=True)
            continue
        libs[name] = lib
    return libs


def main(argv=None):
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--out", default=os.path.join("build", "softmax_probe"))
    ap.add_argument("--backward", action="store_true",
                    help="take the backward apart instead (BWD_VARIANTS)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("softmax_probe: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import softmax as S
    from apex_tpu_torch.tools.flash_timing import _profiled, _queued

    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = BWD_VARIANTS if args.backward else VARIANTS
    libs = _build_variants(_build, args.root, out_dir, variants)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for tag, shape, mshape, causal in (
            ("bert", (16, 16, 512, 512), (16, 1, 1, 512), False),
            ("gpt_causal", (4, 16, 1024, 1024), None, True)):
        x = (3 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
        m = None if mshape is None else torch.rand(
            mshape, generator=g, device=dev) < 0.3
        if args.backward:
            # the backward from the plain forward's y, no mask (the widths
            # where it takes none); the reference is the kernel as it is
            dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            yp = S.scale_mask_softmax_reference(x, m, 0.125, causal)
            call = (lambda dy=dy, yp=yp: S.softmax_bwd_kernel(dy, yp, 0.125))
            cases.append((tag, call, None, None))
            continue
        ref = S.scale_mask_softmax_reference(x, m, 0.125, causal).float()
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-38))) - 7)
        call = (lambda x=x, m=m, causal=causal:
                S.softmax_fwd_kernel(x, m, 0.125, causal))
        cases.append((tag, call, ref, ulp.clamp_min(2.0 ** -133)))
    record = dict(card=torch.cuda.get_device_name(0), rows={})
    names = list(libs) + list(libs)[::-1]
    entry = "apex_softmax_bwd" if args.backward else "apex_softmax_fwd"
    for name in names:
        _build._paths["softmax"] = libs[name]
        _build._libs.pop("softmax", None)
        _build._fns.pop(("softmax", entry), None)
        for i, (tag, call, ref, ulp) in enumerate(cases):
            if variants[name][1]:
                got = call().float()
                if ref is None:
                    # every backward variant must equal the kernel bitwise
                    ref, ulp = got, 0.0
                    cases[i] = (tag, call, ref, ulp)
                if not bool(((got - ref).abs() <= ulp).all()):
                    raise RuntimeError(f"{name} disagrees with the plain version "
                                       f"at {tag}")
            row = record["rows"].setdefault(f"{name}/{tag}", dict(
                device_ms=[], queued_ms=[]))
            row["device_ms"].append(_profiled(torch, call, iters=30)[0])
            row["queued_ms"].append(_queued(torch, call, iters=30))
    for key, row in record["rows"].items():
        print(key, json.dumps(row), flush=True)
    name = "softmax_probe_bwd.json" if args.backward else "softmax_probe.json"
    with open(out_dir / name, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
