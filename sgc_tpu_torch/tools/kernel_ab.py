#!/usr/bin/env python3
"""CUDA-event A/B runs of the port's kernels A, C and D on one card, at
the chip smoke's full-scale clustered-Reddit splits.

    python3 -m sgc_tpu_torch.tools.kernel_ab [--scale 1.0] [--reps 5]
        [--kernels a,c,d] [--baseline-c path/to/tiled_spmm.cu]
        [--baseline-d path/to/sddmm.cu]

Kernel C: the current kernel (``csrc/spmm_csr.cu`` on the layout's edges
re-sorted by row) on the onehot main and last-hop splits, beside
``torch.addmm`` over the main split's slots as one coalesced CSR matrix,
and variants of the kernel made by rewriting one constant each
(``CURRENT_VARIANTS``).
With ``--baseline-c`` (the row-ownership kernel C of an earlier commit,
whose C entry ``tiled_spmm`` takes ``rows, cols, vals, rb_chunk_ptr,
chunk_st, chunk_nnz, x, out, n_rb, n_rows, n_cols, F, R, W, C, stream``)
it also times that kernel and variants of it made by rewriting its
constants, one limit each:

* ``base``: as written (32 features per CTA, 512-row CTAs, stripe staged);
* ``unstaged``: ``W_STAGED_MAX = 0``, x read straight from L1/L2, no
  stripe staging and no barriers;
* ``rows256``: ``RT_MAX = 256``, 96 KB of shared memory, so two CTAs fit
  an SM;
* ``no_search``: each warp's slot range taken in proportion to its rows
  instead of by the warp-wide search (timing only: the sums are wrong).

Kernel A: ``apply_cells`` on the block-dense main split at both
precisions, each with its error against the plain f32 product and the
plain product on bf16(x), and variants of the kernel made by rewriting
its source (``A_VARIANTS``), among them a third bf16 term of x at
``"f32"``.

Kernel D: ``sddmm`` on the main operator in its LPA order and in its
shuffled order (a = the features, b = one hop of them) at both
precisions, the wrapper's bf16 copy of b alone, and variants of the
kernel made by rewriting one constant each (``D_VARIANTS``: edges per
warp, edges in flight, warps per CTA, register bound), each with its
error against the plain version. With ``--baseline-d`` (the warp-per-edge
kernel D of an earlier commit, whose C entry ``sddmm`` takes ``rows,
cols, a, b, out, nnz, e_pad, F, stream``) it also times that kernel on
both orders in the same call.

Prints one JSON line per measurement and the card's name and power
limit; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


# variants of the current kernel C: features held per lane (NV = 10: one
# pass of 640 at F = 602, more registers), with two edges unrolled,
# registers capped for six CTAs per SM, and 4-warp CTAs
CURRENT_VARIANTS = {
    "base": [],
    "nv10": [(r"NV = 5;", "NV = 10;")],
    "nv10_unroll2": [(r"NV = 5;", "NV = 10;"),
                     (r"#pragma unroll 1\n", "#pragma unroll 2\n")],
    "min_ctas6": [(r"__launch_bounds__\(WARPS \* 32\)",
                   "__launch_bounds__(WARPS * 32, 6)")],
    "warps4": [(r"WARPS = 8;", "WARPS = 4;")],
}

# variants of kernel A: as written, with a 3-deep ring, and with a third
# bf16 term of x (its entry then also takes terms = 3)
A_VARIANTS = {
    "base": [],
    "stages3": [(r"STAGES = 4;", "STAGES = 3;")],
    "terms3": [(r"    default:\n", "    case 3:\n      return launch<3>(cells,"
                " x, xs, out, rb_ptr, cell_of, st_ids, n_rb, n_rows, n_cols,"
                " n_x_rows, F, F_pad, R, W, s);\n    default:\n")],
}
# (precision, terms) each variant of kernel A runs at
A_RUNS = {"terms3": (("f32", 3),)}
A_DEFAULT_RUNS = (("bf16", 1), ("f32", 2))

BASELINE_VARIANTS = {
    "base": [],
    "unstaged": [(r"W_STAGED_MAX = \d+;", "W_STAGED_MAX = 0;")],
    "rows256": [(r"RT_MAX = \d+;", "RT_MAX = 256;")],
    "no_search": [(
        r"const int a = warp_lower_bound\(kr, 0, nnz, key_lo, lane\);\s*"
        r"const int b = warp_lower_bound\(kr, a, nnz, key_hi, lane\);",
        "const int a = static_cast<int>(static_cast<int64_t>(nnz) * w_lo"
        " / rt_rows);\n    const int b = static_cast<int>("
        "static_cast<int64_t>(nnz) * w_hi / rt_rows);")],
}


V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entries' argument types
CSR_ARGS = [V] * 6 + [I] * 3 + [V]
A_ARGS = [V] * 7 + [I] * 9 + [V]
BASELINE_C_ARGS = [V] * 8 + [I] * 7 + [V]
D_ARGS = [V] * 5 + [L, L, I, I, I, V]
BASELINE_D_ARGS = [V] * 5 + [L, L, I, V]

# variants of kernel D: edges per warp (the segment that cuts long rows),
# edges in flight, warps per CTA and the register bound
D_VARIANTS = {
    "base": [],
    "seg32": [(r"SEG = 64;", "SEG = 32;")],
    "seg128": [(r"SEG = 64;", "SEG = 128;")],
    "seg256": [(r"SEG = 64;", "SEG = 256;")],
    "eif2": [(r"EIF = 4;", "EIF = 2;")],
    "warps8": [(r"WARPS = 4;", "WARPS = 8;")],
    "one_cta_bound": [(r"__launch_bounds__\(WARPS \* 32, 2\)",
                       "__launch_bounds__(WARPS * 32)")],
    "min_ctas4": [(r"__launch_bounds__\(WARPS \* 32, 2\)",
                   "__launch_bounds__(WARPS * 32, 4)")],
}


def build_variants(source: Path, variants: dict, argtypes: list,
                   out_dir: Path, symbol: str) -> dict:
    """Compile each variant (a list of source rewrites) of a kernel source
    in parallel; returns {variant: (ctypes function ``symbol`` taking
    ``argtypes``, ptxas register counts)}."""
    from sgc_tpu_torch.utils.buildlib import nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    procs = {}
    for name, subs in variants.items():
        src = text
        for pat, rep in subs:
            src, n = re.subn(pat, rep, src)
            if n != 1:
                raise RuntimeError(f"variant {name}: pattern not found")
        cu = out_dir / f"{source.stem}_{symbol}_{name}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{cu.stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"building variant {name} failed:\n{out}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = I
        fns[name] = (fn, [int(m) for m in
                          re.findall(r"Used (\d+) registers", out)])
    return fns


def kernel_c(data, device, reps: int, baseline: Path | None) -> None:
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import spmm_tiled as ti

    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    tiled = plan.split_main.tiled
    args = plan._device_args()[0].tiled
    x = torch.as_tensor(plan.features, device=device)
    F = int(x.shape[1])
    want = ti.spmm_tiled_plain(tiled, x)
    got = ti.spmm_tiled_flat(tiled, x, args)
    emit({"kernel": "C", "variant": "current", "ms": time_ms(
        lambda: ti.spmm_tiled_flat(tiled, x, args), reps),
        "rel_err": rel_err(got, want), "slots": int(tiled.rows.shape[0]),
        "edges": int(args.cols.shape[0])})
    del got
    rows, cols, vals = (torch.as_tensor(a, device=device)
                        for a in (tiled.rows, tiled.cols, tiled.vals))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        csr = torch.sparse_coo_tensor(
            torch.stack([rows, cols]).long(), vals,
            (tiled.n_rows, tiled.n_cols)).coalesce().to_sparse_csr()
    zero = x.new_zeros((tiled.n_rows, F))
    emit({"kernel": "C", "variant": "library_addmm", "ms": time_ms(
        lambda: torch.addmm(zero, csr, x, beta=0.0), reps)})
    del csr, zero
    final = plan.split_final.tiled
    args_final = plan._device_args()[1].tiled
    emit({"kernel": "C", "variant": "current_last_hop", "ms": time_ms(
        lambda: ti.spmm_tiled_flat(final, x, args_final), reps),
        "edges": int(args_final.cols.shape[0])})
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    out = torch.empty((tiled.n_rows, F), device=device)
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "spmm_csr.cu",
                         CURRENT_VARIANTS, CSR_ARGS, out_dir, "csr_spmm")
    for name, (fn, regs) in fns.items():
        def run(fn=fn):
            rc = fn(args.row_ptr.data_ptr(), args.cols.data_ptr(),
                    args.vals.data_ptr(), x.data_ptr(), None,
                    out.data_ptr(), tiled.n_rows, F, 0, kernels.stream_of(x))
            kernels.check_launch(rc, f"current {name}")
        run()
        torch.cuda.synchronize()
        emit({"kernel": "C", "variant": f"current_{name}", "registers": regs,
              "ms": time_ms(run, reps), "rel_err": rel_err(out, want)})
    if baseline is None:
        return
    fns = build_variants(baseline, BASELINE_VARIANTS, BASELINE_C_ARGS,
                         out_dir, "tiled_spmm")
    ptr, chunk_st = ti.flat_index(tiled)
    ptr = torch.from_numpy(ptr).to(device)
    chunk_st = torch.from_numpy(chunk_st).to(device)
    nnz = torch.from_numpy(ti.chunk_nnz(tiled)).to(device)

    for name, (fn, _) in fns.items():
        def run(fn=fn):
            rc = fn(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                    ptr.data_ptr(), chunk_st.data_ptr(), nnz.data_ptr(),
                    x.data_ptr(), out.data_ptr(), tiled.n_row_blocks,
                    tiled.n_rows, tiled.n_cols, F, tiled.row_block,
                    tiled.stripe, tiled.chunk, kernels.stream_of(x))
            kernels.check_launch(rc, f"baseline {name}")
        run()
        torch.cuda.synchronize()
        emit({"kernel": "C", "variant": f"baseline_{name}",
              "ms": time_ms(run, reps), "rel_err": rel_err(out, want)})


def kernel_a(data, device, reps: int) -> None:
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import spmm_blockdense as bd

    plan = LocalityPlan.build(*data, formulation="auto", device=device)
    split, dargs = plan.split_main, plan._device_args()[0]
    x = torch.as_tensor(plan.features, device=device)
    want = {p: bd.apply_cells_plain(split, dargs, x, p)
            for p in bd.PRECISIONS}
    for precision in bd.PRECISIONS:
        got = bd.apply_cells(split, dargs, x, precision)
        again = bd.apply_cells(split, dargs, x, precision)
        emit({"kernel": "A", "precision": precision,
              "terms": bd.n_passes(precision), "cells": split.n_cells,
              "ms": time_ms(
                  lambda: bd.apply_cells(split, dargs, x, precision), reps),
              "rel_err_vs_plain_f32": rel_err(got, want["f32"]),
              "rel_err_vs_plain_bf16": rel_err(got, want["bf16"]),
              "identical_launches": bool(torch.equal(got, again))})
        del got, again
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "blockdense.cu",
                         A_VARIANTS, A_ARGS,
                         ROOT / "build" / "sgc_tpu_torch" / "ab",
                         "blockdense_cells")
    R, W = split.row_block, split.stripe
    F = int(x.shape[1])
    f_pad = -(-F // bd.FEATURE_TILE) * bd.FEATURE_TILE
    n_x_rows = split.n_stripes * W
    out = torch.empty((split.n_rows, F), device=device)
    for name, (fn, regs) in fns.items():
        for precision, terms in A_RUNS.get(name, A_DEFAULT_RUNS):
            xs = torch.empty((terms, n_x_rows, f_pad), dtype=torch.bfloat16,
                             device=device)

            def run(fn=fn, xs=xs, terms=terms):
                rc = fn(dargs.cells.data_ptr(), x.data_ptr(), xs.data_ptr(),
                        out.data_ptr(), dargs.rb_ptr.data_ptr(),
                        dargs.cell_of.data_ptr(), dargs.st_ids.data_ptr(),
                        split.n_row_blocks, split.n_rows, split.n_cols,
                        n_x_rows, F, f_pad, R, W, terms,
                        kernels.stream_of(x))
                kernels.check_launch(rc, f"kernel A {name}")
            run()
            torch.cuda.synchronize()
            emit({"kernel": "A", "variant": name, "precision": precision,
                  "terms": terms, "registers": regs,
                  "ms": time_ms(run, reps),
                  "rel_err": rel_err(out, want[precision])})
            del xs


def kernel_d(data, device, reps: int, baseline: Path | None) -> None:
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import spmm as sp

    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    orders = {"lpa": (plan.graph, plan.features),
              "shuffled": (data[0], data[1])}
    del plan
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "sddmm.cu",
                         D_VARIANTS, D_ARGS, out_dir, "sddmm")
    base_fn = None
    if baseline is not None:
        base_fn = build_variants(baseline, {"base": []}, BASELINE_D_ARGS,
                                 out_dir, "sddmm")["base"][0]
    for order, (graph, feats) in orders.items():
        g = graph.to(device)
        x = torch.as_tensor(feats, device=device)
        b = sp.spmm_segment(g, x)
        want = {p: sp.sddmm_plain(g, x, b, p) for p in sp.PRECISIONS}
        emit({"kernel": "D", "order": order, "variant": "bf16_copy_b",
              "ms": time_ms(lambda: sp._kernel_copy(b, "bf16"), reps)})
        for name, (fn, regs) in fns.items():
            for p in sp.PRECISIONS:
                got = sp._sddmm_cuda(g, x, b, p, fn)
                emit({"kernel": "D", "order": order, "variant": name,
                      "precision": p, "registers": regs,
                      "ms": time_ms(lambda: sp._sddmm_cuda(g, x, b, p, fn),
                                    reps),
                      "rel_err": rel_err(got, want[p])})
                del got
        if base_fn is not None:
            out = torch.empty(g.n_edges_padded, device=device)

            def run():
                rc = base_fn(g.rows.data_ptr(), g.cols.data_ptr(),
                             x.data_ptr(), b.data_ptr(), out.data_ptr(),
                             g.nnz, g.n_edges_padded, int(x.shape[1]),
                             kernels.stream_of(x))
                kernels.check_launch(rc, "baseline sddmm")
            run()
            torch.cuda.synchronize()
            emit({"kernel": "D", "order": order, "variant": "baseline",
                  "precision": "f32", "ms": time_ms(run, reps),
                  "rel_err": rel_err(out, want["f32"])})
        del g, x, b, want
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default="a,c,d",
                    help="comma-separated kernels to run")
    ap.add_argument("--baseline-c", type=Path, default=None)
    ap.add_argument("--baseline-d", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kernels.build_all()
    data = synthetic_reddit_clustered(args.scale, seed=args.seed,
                                      shuffle=True)
    chosen = set(args.kernels.split(","))
    if "a" in chosen:
        kernel_a(data, device, args.reps)
    if "c" in chosen:
        kernel_c(data, device, args.reps, args.baseline_c)
    if "d" in chosen:
        kernel_d(data, device, args.reps, args.baseline_d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
