"""Try tile plans of the flash forward at head dim 80 on the card.

Run on a machine with an NVIDIA Hopper card, as a script:

    python3 apex_tpu_torch/tools/flash_fwd_probe.py [--root DIR] [--out DIR]

It builds variants of the ``flash_attention`` library of the checkout
under ``--root`` (default: the checkout holding this script), each
differing from ``csrc/flash_attention.cu`` in the forward's tile plan at
head dim 80 — keys a tile (``fwd_bn``: 128 or 64) and stages of K and V
in the ring (``kHStages``: 2 or 3) — plus ``fma``, the FMA forward
that took head dim 80 before the wgmma route did.  Only the forward is
built (the backward entry points return an error, so ``kHStages``
reaches the forward alone), with ``-Xptxas -v``,
so each variant's registers and spill bytes at head dim 80 are
reported.  Each variant is first held against the plain version
(``flash_fwd_reference``: ``o`` within 2^-7 of max |ref|, the live
``lse`` within 1e-5, dead rows below -1e29) at ViT-Huge's shape in bf16
and fp16 and at a ragged key-padding case with dropout and a causal GQA
case with a window, then timed at ViT-Huge (b 32, s 257, h 16, d 80,
bf16) as device ms per call (torch.profiler) and ms per call between
CUDA events with the host's enqueue hidden, in turns (every variant,
then every variant again in reverse order).  A variant the compiler
refuses is reported and left out.  The record goes to
``<--out>/flash_fwd_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

_BN = "constexpr int fwd_bn(int d) { return d == 80 ? 64 : 128; }"
_STAGES = "constexpr int kHStages = 2;"
_ROUTE = "return dt != apex::kF32 && (d == 64 || d == 80 || d == 128);"
# the backward entries' bodies, left out of every variant's build
_NO_BWD = [("APEX_TC_BY_D(dq_wgmma, p, dt, dout, l, dl, dq, st)", "return 1;"),
           ("APEX_FMA_DT(bwd_dq, p, dout, l, dl, dq, st)", "return 1;"),
           ("APEX_TC_BY_D(dkv_wgmma, p, dt, dout, l, dl, dk, dv, st)",
            "return 1;"),
           ("APEX_FMA_DT(bwd_dkv, p, dout, l, dl, dk, dv, st)", "return 1;")]


def _plan(bn, stages):
    return [(_BN, _BN.replace("d == 80 ? 64", f"d == 80 ? {bn}")),
            (_STAGES, _STAGES.replace("2", str(stages)))]


#: variant -> replacements
VARIANTS = {
    "fma": [(_ROUTE, "return dt != apex::kF32 && (d == 64 || d == 128);")],
    "bn128_s2": _plan(128, 2),
    "bn128_s3": _plan(128, 3),
    "bn64_s2": _plan(64, 2),
    "bn64_s3": _plan(64, 3),
}


def _build_variants(_build, root, out_dir):
    """Compile every variant (all ``nvcc`` at once); returns their paths
    and each one's ``-Xptxas -v`` lines of the head-dim-80 forward."""
    csrc = Path(root) / "apex_tpu_torch" / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs + _NO_BWD:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old[:50]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"flash_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libflash_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, "-I",
             str(csrc), "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log[-3000:]}", flush=True)
            continue
        libs[name] = lib
        lines, fn = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and "fa_fwd" in fn and "Li80E" in fn and (
                    "Used" in line or "spill" in line):
                lines.append(line.strip())
        ptxas[name] = sorted(set(lines))
    return libs, ptxas


def main(argv=None):
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(here))
    ap.add_argument("--out", default=os.path.join("build", "flash_fwd_probe"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as A
    from apex_tpu_torch.tools.flash_timing import _profiled, _queued

    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, ptxas = _build_variants(_build, args.root, out_dir)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    checks = []
    # (b, sq, sk, h, hk, causal, window, key-padding bias, rate, dtype)
    for b, sq, sk, h, hk, causal, window, pad, rate, dt in (
            (32, 257, 257, 16, 16, False, None, False, 0.0, torch.bfloat16),
            (32, 257, 257, 16, 16, False, None, False, 0.0, torch.float16),
            (2, 257, 257, 4, 4, False, None, True, 0.1, torch.bfloat16),
            (2, 200, 200, 8, 2, True, 50, False, 0.1, torch.float16)):
        q = torch.randn(b, sq, h, 80, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, sk, hk, 80, generator=g, device=dev).to(dt)
                for _ in range(2))
        bias = None
        if pad:
            lens = torch.randint(sk // 2, sk + 1, (b,), generator=g,
                                 device=dev)
            bias = A.mask_to_bias(torch.arange(sk, device=dev)[None, :]
                                  >= lens[:, None]).view(b, 1, 1, sk)
        fa = (bias, 80 ** -0.5, causal, window, rate, 20240613)
        checks.append(((b, sq, sk, h, hk, str(dt)[6:], causal, window, pad,
                        rate), q, k, v, fa, A.flash_fwd_reference(q, k, v, *fa)))
    vit = checks[0]
    record = dict(card=torch.cuda.get_device_name(0), ptxas=ptxas, rows={},
                  checks={})
    names = list(libs) + list(libs)[::-1]
    for i, name in enumerate(names):
        _build._paths["flash_attention"] = libs[name]
        _build._libs.pop("flash_attention", None)
        _build._fns.pop(("flash_attention", "apex_fa_fwd"), None)
        if i < len(libs):
            for case, q, k, v, fa, (o2, lse2) in checks:
                o, lse = A.flash_fwd_kernel(q, k, v, *fa)
                live = lse2 > -1e29
                err = float((o.float() - o2.float()).abs().max())
                tol = 2.0 ** -7 * float(o2.float().abs().max())
                lerr = float((lse[live] - lse2[live]).abs().max())
                ok = (err <= tol and lerr <= 1e-5
                      and bool((lse[~live] < -1e29).all()))
                record["checks"][f"{name}/{case}"] = dict(
                    max_abs_err=err, tol=tol, lse_err=lerr, ok=ok)
                if not ok:
                    raise RuntimeError(f"{name} disagrees with the plain "
                                       f"version at {case}: {err} > {tol} "
                                       f"or lse {lerr}")
        _, q, k, v, fa, _ = vit
        row = record["rows"].setdefault(name, dict(device_ms=[],
                                                   queued_ms=[]))
        call = (lambda q=q, k=k, v=v, fa=fa: A.flash_fwd_kernel(q, k, v, *fa))
        row["device_ms"].append(_profiled(torch, call, iters=30)[0])
        row["queued_ms"].append(_queued(torch, call, iters=30))
    for name in libs:
        print(name, json.dumps(dict(record["rows"][name],
                                    ptxas=ptxas[name])), flush=True)
    with open(out_dir / "flash_fwd_probe.json", "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
