#!/usr/bin/env python3
"""Where an iteration of K3's wide unit (``csrc/lm_wide.cu``) spends its
time on the card: a cycle count per part, from ``clock64()`` stamps.

Run from the repository root on a machine with a CUDA card::

    python3 lm_split.py [--root CHECKOUT] [--lanes 4096] [--widths 16:fp32 24:fp32 71:fp64]
                        [--define NAME=VALUE ...] [--no-stamps]

It copies ``npswf_tpu_torch/csrc/lm_wide.cu`` of the checkout at ``--root``
(default: this one) to ``build/lm_split/``, puts a stamp after every
barrier of the copy (``tile.sync()``, ``__syncthreads()``,
``pair_sync()``), builds the copy alone with nvcc against that checkout's
headers, and runs it on chip_smoke's LM inputs (``lm_inputs``: up to 8
pulses a lane, the stage-1 cap). Thread 0 of each lane's block adds the
cycles since the previous stamp to the barrier's site, so a site holds the
time the lane spent from the barrier before it to its own, waiting
included. Sites are named after the function around them and mapped to
the iteration's parts (``PARTS``). The package's kernel is not touched:
the stamps exist only in the copy. ``--define`` builds the copy with
another value of one of its ``constexpr int`` constants, and
``--no-stamps`` builds it without stamps and times it alone (mean of three
launches), to compare variants of the unit in one call. Each width prints
one line; the last line is one JSON object with every width's cycles per
iteration by part.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (function around the barrier, its ordinal there) -> part. The first
# block is the unit's first design (one warp a lane), the second the one
# with several warps a lane; a site of neither falls under its function's
# name.
PARTS = {
    ("system", 0): "transform", ("system", 1): "staging",
    ("system", 2): "gram", ("gcrit", 0): "gcrit", ("step", 0): "scaling",
    ("factor", 0): "factor", ("solve", 0): "forward",
    ("solve", 1): "forward", ("solve", 2): "back", ("step", 1): "update",
    ("transform", 0): "transform", ("stage", 0): "staging",
    ("gram", 0): "gram", ("scale", 0): "scaling",
    ("factor_forward", 0): "panels", ("factor_forward", 1): "trailing",
    ("back_solve", 0): "back", ("back_solve", 1): "back",
    ("update", 0): "update",
}
BARRIER = re.compile(r"\b(tile\.sync|__syncthreads|pair_sync)\(\);")
FUNC = re.compile(r"^\s*(?:__device__[^(;]*?\b(\w+)\s*\(|(lm_wide_kernel)\()")
KERNEL_ANCHOR = "extern __shared__ __align__(16) unsigned char smem[];"
OPTIN = "return (size_t)v;"

STAMPS = r"""
// ---- lm_split.py: clock64() stamps (this copy only) ----
__device__ long long* g_split;        // [lanes, NSITES]
__shared__ long long split_last;
__shared__ long long split_acc[NSITES];
__device__ __forceinline__ void split_init() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSITES; ++i) split_acc[i] = 0;
    split_last = clock64();
  }
}
__device__ __forceinline__ void split_stamp(int site) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    split_acc[site] += t - split_last;
    split_last = t;
    g_split[(size_t)blockIdx.x * NSITES + site] = split_acc[site];
  }
}
"""

ENTRY = r"""
extern "C" int split_launch(int dtype, int p, const void* const* in,
                            void* const* out, int n, int nk, int fit_lo,
                            int max_iter, const double* prm_d,
                            long long* stamps) {
  npswf::LMParams prm;
  prm.lam_up = prm_d[0]; prm.lam_down = prm_d[1]; prm.lam_min = prm_d[2];
  prm.lam_max = prm_d[3]; prm.ftol = prm_d[4]; prm.gtol = prm_d[5];
  prm.eps = prm_d[6]; prm.gate_lo = prm_d[7]; prm.gate_hi = prm_d[8];
  prm.sat = prm_d[9]; prm.chol_eps = prm_d[10];
  prm.fit_lo = fit_lo; prm.nk = nk; prm.n = n; prm.max_iter = max_iter;
  cudaMemcpyToSymbol(g_split, &stamps, sizeof(stamps));
  return (int)(dtype == 0
      ? npswf::launch_wide<float>(p, in, out, prm, 0)
      : npswf::launch_wide<double>(p, in, out, prm, 0));
}
"""


def instrument(src: str, stamps: bool = True):
    """The source with a stamp after every barrier (none if not
    ``stamps``), and the sites [(function, ordinal, line)]."""
    if not stamps:
        head, sep, rest = src.partition("namespace npswf {")
        return head + "#define NSITES 1\n" + STAMPS + sep + rest + ENTRY, []
    lines = src.splitlines()
    func, seen, sites, out = "(file)", {}, [], []
    for no, line in enumerate(lines, 1):
        m = FUNC.match(line)
        if m:
            func = m.group(1) or m.group(2)
        parts = BARRIER.split(line)
        if len(parts) == 1:
            out.append(line)
            continue
        new = parts[0]
        for i in range(1, len(parts), 2):
            ordinal = seen.get(func, 0)
            seen[func] = ordinal + 1
            new += f"{{ {parts[i]}(); split_stamp({len(sites)}); }}" + parts[i + 1]
            sites.append((func, ordinal, no))
        out.append(new)
    text = "\n".join(out) + "\n"
    if KERNEL_ANCHOR not in text or OPTIN not in text:
        raise SystemExit("lm_split: the source lacks the kernel's shared-memory "
                         "declaration or smem_optin()")
    text = text.replace(KERNEL_ANCHOR, KERNEL_ANCHOR + " split_init();", 1)
    # the stamps' static shared memory comes off what a lane may take
    text = text.replace(OPTIN, "return (size_t)v - 16 * (NSITES + 2);", 1)
    head, sep, rest = text.partition("namespace npswf {")
    text = (head + f"#define NSITES {len(sites)}\n" + STAMPS + sep + rest
            + ENTRY)
    return text, sites


def define(src: str, name: str, value: str) -> str:
    """The source with ``constexpr int name = value;``."""
    pat = re.compile(r"constexpr int %s = [^;]+;" % re.escape(name))
    if not pat.search(src):
        raise SystemExit(f"lm_split: no constexpr int {name} in the source")
    return pat.sub(f"constexpr int {name} = {value};", src, count=1)


def build(root: str, out_dir: str, defines=(), stamps=True):
    from npswf_tpu_torch import kernels
    src = open(os.path.join(root, "npswf_tpu_torch", "csrc", "lm_wide.cu")).read()
    for d in defines:
        name, _, value = d.partition("=")
        src = define(src, name, value)
    text, sites = instrument(src, stamps)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "lm_wide_split.cu")
    so = os.path.join(out_dir, "liblm_split.so")
    with open(cu, "w") as f:
        f.write(text)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
           os.path.join(root, "npswf_tpu_torch", "csrc"), cu, "-o", so]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise SystemExit(f"lm_split: nvcc failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.split_launch.argtypes = [I_, I_, P_, P_, I_, I_, I_, I_, P_, P_]
    lib.split_launch.restype = I_
    lib.npswf_lm_max_pulses.argtypes = [I_, I_]
    lib.npswf_lm_max_pulses.restype = I_
    return lib, sites


def run_width(torch, lib, sites, cfg, cal, P, dt, lanes):
    """One launch of the copy at P pulses: cycles a lane-iteration by part,
    and the launch's time."""
    from chip_smoke import lm_inputs
    from npswf_tpu_torch.fit.lm import CHOL_EPS, SAT_THRESH
    dev = torch.device("cuda", 0)
    cfg = cfg.replace(maxwfpulses=max(P, 15))
    (coeffs, x0, y, w, u0, lo, hi, pseed, pm, act, max_iter, lam0,
     budget) = lm_inputs(torch, cfg, cal, lanes, 8, P, 91 + P + lanes, dt, dev)
    N, M = u0.shape
    K = y.shape[1]
    budget = torch.clamp(budget.to(torch.int32), max=max_iter).contiguous()
    ins = (coeffs, x0, y.t().contiguous(), w.t().contiguous(), u0, lo, hi,
           pseed, pm.to(torch.uint8).contiguous(),
           act.to(torch.uint8).contiguous(), budget,
           (torch.zeros((N,), dtype=dt, device=dev) + lam0).contiguous())
    outs = (torch.empty((N, M), dtype=dt, device=dev),
            torch.empty((N,), dtype=dt, device=dev),
            torch.empty((N,), dtype=torch.uint8, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev),
            torch.empty((N,), dtype=dt, device=dev),
            torch.empty((N,), dtype=dt, device=dev))
    stamps = torch.zeros((N, max(len(sites), 1)), dtype=torch.int64,
                         device=dev)
    eps = float(torch.finfo(dt).eps)
    prm = torch.tensor([cfg.lm_lambda_up, cfg.lm_lambda_down,
                        cfg.lm_lambda_min, cfg.lm_lambda_max,
                        max(cfg.lm_ftol, 100 * eps), max(cfg.lm_gtol, 100 * eps),
                        eps, cfg.spline_gate_lo, cfg.ntime - 1, SAT_THRESH,
                        CHOL_EPS], dtype=torch.float64)
    in_p = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in ins))
    out_p = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in outs))

    def launch():
        code = lib.split_launch(0 if dt == torch.float32 else 1, P, in_p,
                                out_p, N, K, cfg.fit_lo_bin, int(max_iter),
                                ctypes.c_void_p(prm.data_ptr()),
                                ctypes.c_void_p(stamps.data_ptr()))
        if code != 0:
            raise SystemExit(f"lm_split: launch failed at P={P} {dt}: {code}")
    launch()
    torch.cuda.synchronize()
    reps = 1 if sites else 3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    stamps.zero_()
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    iters = int(outs[3].to(torch.int64).sum())
    tot = stamps.sum(dim=0).tolist()
    by_part, by_site = {}, []
    for (func, ordinal, line), cyc in zip(sites, tot):
        part = PARTS.get((func, ordinal), func)
        by_part[part] = by_part.get(part, 0) + cyc
        by_site.append({"function": func, "ordinal": ordinal, "line": line,
                        "part": part, "cycles_per_iteration": cyc / max(iters, 1)})
    per_it = {k: v / max(iters, 1) for k, v in by_part.items()}
    return {"P": P, "dtype": str(dt), "lanes": N, "iterations": iters,
            "launch_ms": ms, "cycles_per_iteration": per_it,
            "cycles_per_iteration_total": sum(per_it.values()),
            "sites": by_site}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--widths", nargs="+",
                    default=["16:fp32", "24:fp32", "71:fp64"],
                    help="P:fp32|fp64 pairs; P may be 'limit'")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "lm_split"))
    ap.add_argument("--define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="build the copy with constexpr int NAME = VALUE")
    ap.add_argument("--no-stamps", action="store_true",
                    help="time the copy without stamps (mean of 3 launches)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import card_line
    from npswf_tpu_torch.core.calibration import synthetic_calibration
    from npswf_tpu_torch.core.config import NPSConfig
    card = card_line()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    t0 = time.perf_counter()
    tag = "_".join([os.path.basename(os.path.abspath(args.root)) or "root",
                    *args.define] + (["plain"] if args.no_stamps else []))
    out_dir = os.path.join(args.out, tag)
    lib, sites = build(args.root, out_dir, args.define, not args.no_stamps)
    with open(os.path.join(out_dir, "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[split] {args.root} {' '.join(args.define)}: {len(sites)} "
          f"barrier sites, built in "
          f"{time.perf_counter() - t0:.1f} s; {card}; clocks {clocks}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    cfg = NPSConfig(compute_dtype="float32")
    cal = synthetic_calibration(cfg, seed=1)
    res = []
    for spec in args.widths:
        p, _, name = spec.partition(":")
        dt = torch.float64 if name == "fp64" else torch.float32
        P = (lib.npswf_lm_max_pulses(0 if dt == torch.float32 else 1,
                                     cfg.nfitbins) if p == "limit" else int(p))
        r = run_width(torch, lib, sites, cfg, cal, P, dt, args.lanes)
        res.append(r)
        parts = ", ".join(f"{k} {v:.0f}" for k, v in
                          sorted(r["cycles_per_iteration"].items(),
                                 key=lambda kv: -kv[1]))
        print(f"[split] P={P} {name} {r['lanes']} lanes, {r['iterations']} "
              f"iterations, {r['launch_ms']:.4f} ms (stamped): cycles a "
              f"lane-iteration {r['cycles_per_iteration_total']:.0f}: {parts}",
              flush=True)
    print(json.dumps({"lm_split": res, "root": os.path.abspath(args.root),
                      "defines": args.define, "stamps": not args.no_stamps,
                      "ptxas": ptxas,
                      "card": card, "clocks": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
