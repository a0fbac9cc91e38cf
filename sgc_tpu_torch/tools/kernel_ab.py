#!/usr/bin/env python3
"""CUDA-event A/B runs of the port's kernels A, B, C, D, G and H on one
card, at the chip smoke's full-scale clustered-Reddit splits (G at the
gather probe's defaults).

    python3 -m sgc_tpu_torch.tools.kernel_ab [--scale 1.0] [--reps 5]
        [--kernels a,b,c,d,g,h] [--baseline-b path/to/spmm_csr.cu]
        [--baseline-c path/to/tiled_spmm.cu]
        [--baseline-d path/to/sddmm.cu]
        [--baseline-g path/to/edge_accumulate.cu]
        [--baseline-h path/to/blockdense_int8.cu]

Kernel B (``csrc/spmm_csr.cu``) at every width its callers use, each on
its own operand (``b_cases``): F = 1, 8, 16, 41 and 64 on the shuffled
Reddit-shape graph (GAT's segment sums and heads, GCN's and deep GCN's
hidden widths), F = 602 over the same graph (a plain hop of
``cli.reddit``), on the block-dense main split's remainder with its
dense term, and with x 4 bytes off its alignment, and kernel C's
operand (the onehot main split re-sorted by row) at ``"f32"`` and
``"bf16"``. Each case prints the kernel's plan, its error against the
plain version, its time, bound, library call, gathered bytes per
second, the operand's largest row degree and the time of that row
alone. Variants of the kernel, each made by rewriting one constant of
the source and the plan that goes with it (``B_VARIANTS``: edges per
batch, lanes per row, warps per CTA, register bounds, x bytes in flight,
the edge stream staged in shared memory or not and its chunk size),
must give the base kernel's bits. With ``--baseline-b`` (the
kernel of an earlier commit, whose C entry ``csr_spmm`` takes ``row_ptr,
cols, vals, x, dense, out, n_rows, F, x_bf16, stream``) it also times
that kernel on every case and raises unless it gives the same bits.

Kernel C: the current kernel (``csrc/spmm_csr.cu`` on the layout's edges
re-sorted by row) on the onehot main and last-hop splits, beside
``torch.addmm`` over the main split's slots as one coalesced CSR matrix
(its variants are kernel B's, on kernel C's operand).
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

Kernel G (``csrc/edge_accumulate.cu``) on the gather probe's edges
(65,536 into 2,048 x 768) in every mode: the whole call, the bucket pass
and the accumulate pass alone, each launch's device time under
``torch.profiler``, the FADD chain's cycles a link, ``torch.sparse.mm``
on the same edges, and variants made by rewriting the source
(``G_VARIANTS``: the light rows' slice width, edges read at once and CTA
size, their x slice read from global memory, the heavy ring's depth and
4-byte copies, ``__match_any_sync`` for the bucket pass's ranks); every
variant must give the plain version's bits. With ``--baseline-g`` (the
one-pass kernel of an earlier commit, whose C entry ``edge_accumulate``
takes ``rows, cols, vals, x, out, n_edges, R, W, F, rows_per_cta, mode,
stream``) it also times that kernel in every mode.

Kernel H (``csrc/blockdense_int8.cu``) on the block-dense main split's
cells quantized per cell, x padded to 768: its time, its error against
the plain version, ``torch.addmm`` over the dequantized nonzeros and
kernel A at ``"bf16"`` on the same cells, and variants (``H_VARIANTS``;
those in ``H_TIMING_ONLY`` change the sum and are timed only: ``copy``
takes the cell bytes as bf16 bits with no dequantizing arithmetic,
``flush_in_registers`` skips the running sum, ``no_products`` drops the
wgmmas, leaving the loads, the dequantization and the running sum;
``stages3`` a shorter ring, ``stages3_run96`` with more of the running
sum in shared memory, ``row_block_sum`` the row block's cells summed on
the tensor cores with no running sum). Then ``base`` and
``row_block_sum`` again on random dense int8 cells (seeded) in the main
split's index, where a long f32 sum shows its rounding. With
``--baseline-h`` (the ``mma.sync`` kernel of
an earlier commit, whose C entry ``blockdense_int8_cells`` takes
``cells, scales, xs, out, rb_ptr, cell_of, st_ids, n_rb, n_st, F_pad,
R, W, stream``) it also times that kernel as written and with its
dequantization replaced by the same plain copy (``copy``), which
measures what the dequantizing pass costs that design.

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


# variants of kernel B: (source rewrites, the plan's overrides) — edges
# per batch (U_MIN = 1: one edge in flight at F = 602, as the first
# kernel, but one pass; U_MAX = 32 at F = 1), lanes per row (half the
# plan's, and a warp per row as the first kernel), 4-warp CTAs, the
# register bounds (CTAs per SM for narrow and wide instances, and where
# narrow ends), the chunk at one row a warp, half and twice the x bytes
# in flight per lane, and the edge stream read through L1 instead of
# staged, or staged in other chunk sizes
B_VARIANTS = {
    "base": ([], {}),
    "u_min1": ([(r"U_MIN = 2;", "U_MIN = 1;")], {"u_min": 1}),
    "u_max32": ([(r"U_MAX = 16;", "U_MAX = 32;")], {"u_max": 32}),
    "lanes_half": ([], {"lanes": "half"}),
    "warp_per_row": ([], {"lanes": 32}),
    "warps4": ([(r"WARPS = 8;", "WARPS = 4;")], {"warps": 4}),
    "narrow_ctas1": ([(r"NARROW_MIN_CTAS = 3;", "NARROW_MIN_CTAS = 1;")],
                     {}),
    "narrow_ctas2": ([(r"NARROW_MIN_CTAS = 3;", "NARROW_MIN_CTAS = 2;")],
                     {}),
    "narrow_bytes16": ([(r"NARROW_BYTES = 40;", "NARROW_BYTES = 16;")], {}),
    "wide_ctas2": ([(r"WIDE_MIN_CTAS = 1;", "WIDE_MIN_CTAS = 2;")], {}),
    "many_loads_ctas1": ([(r"MANY_LOADS = 20;", "MANY_LOADS = 1000;")], {}),
    "wide_stage256": ([(r"STAGE_EDGES_WIDE = 128;",
                        "STAGE_EDGES_WIDE = 256;")], {}),
    "in_flight80": ([(r"IN_FLIGHT_BYTES = 160;", "IN_FLIGHT_BYTES = 80;")],
                    {"in_flight": 80}),
    "in_flight320": ([(r"IN_FLIGHT_BYTES = 160;",
                       "IN_FLIGHT_BYTES = 320;")], {"in_flight": 320}),
    "unstaged": ([(r"STAGE_EDGES = 256;", "STAGE_EDGES = 0;")], {}),
    "stage128": ([(r"STAGE_EDGES = 256;", "STAGE_EDGES = 128;")], {}),
    "warps4_stage512": ([(r"WARPS = 8;", "WARPS = 4;"),
                         (r"STAGE_EDGES = 256;", "STAGE_EDGES = 512;"),
                         (r"STAGE_EDGES_WIDE = 128;",
                          "STAGE_EDGES_WIDE = 256;")],
                        {"warps": 4}),
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
CSR_ARGS = [V] * 6 + [I] * 9 + [V]
BASELINE_B_ARGS = [V] * 6 + [I] * 3 + [V]
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


# variants of kernel G: the light rows' slice width (lanes a row) and CTA
# size, their x slice read from global memory, the heavy ring's depth,
# the heavy rows' copies at 4 bytes
G_VARIANTS = {
    "base": [],
    "slice16": [(r"SF = 8;", "SF = 16;")],
    "row_loads4": [(r"ROW_LOADS = 8;", "ROW_LOADS = 4;")],
    "light_1024": [(r"LIGHT_THREADS = 256;", "LIGHT_THREADS = 1024;")],
    "x_unstaged": [(r"X_SMEM_MAX = 160 \* 1024;", "X_SMEM_MAX = 0;")],
    "depth6": [(r"DEPTH = 10;", "DEPTH = 6;")],
    "heavy_copy4b": [(r"const bool vec = F % 4 == 0", "const bool vec = "
                      "false && F % 4 == 0")],
    "match_any": [(r"    unsigned peers = 0;   // the lanes of this group "
                   r"with row r\n#pragma unroll\n    for \(int j = 0; j < 32; "
                   r"\+\+j\)\n      peers \|= static_cast<unsigned>"
                   r"\(__shfl_sync\(FULL, r, j\) == r\) << j;",
                   "    const unsigned peers = __match_any_sync(FULL, r);")],
}
G_ARGS = [V] * 5 + [L] + [I] * 5 + [V] * 9
BASELINE_G_ARGS = [V] * 5 + [L] + [I] * 5 + [V]

# variants of kernel H (timing only where marked in the module note)
H_VARIANTS = {
    "base": [],
    "copy": [(r"  const uint32_t u = w \^ 0x80808080u;",
              "  return w;\n  const uint32_t u = w ^ 0x80808080u;")],
    "flush_in_registers": [(r"const bool last = ci == n_cells - 1;",
                            "const bool last = true;")],
    "stages3": [(r"STAGES = 4;", "STAGES = 3;")],
    "no_products": [(r"\s*wgmma_256\(acc, a\[j\], x_desc\(b_tile \+ j "
                     r"\* 2048\),\n\s*first && j == 0 \? 0 : 1\);", "")],
    "stages3_run96": [(r"STAGES = 4;", "STAGES = 3;"),
                      (r"RUN_REGS = 64;", "RUN_REGS = 32;")],
    # the row block's cells summed on the tensor cores, no running sum
    "row_block_sum": [
        (r"first && j == 0 \? 0 : 1", "ci == 0 && first && j == 0 ? 0 : 1"),
        (r"const bool last = ci == n_cells - 1;", "const bool last = true;"),
        (r"__fadd_rn\(ci == 0 \? 0\.f : run_r\[i\], acc\[i\]\)",
         "__fadd_rn(0.f, acc[i])"),
        (r"float4 r = ci == 0 \? make_float4\(0\.f, 0\.f, 0\.f, 0\.f\)\n"
         r"\s*: my_run\[q \* THREADS\];",
         "float4 r = make_float4(0.f, 0.f, 0.f, 0.f);")],
}
H_TIMING_ONLY = {"copy", "flush_in_registers", "no_products"}
H_ARGS = [V] * 7 + [I] * 6 + [V]
BASELINE_H_ARGS = [V] * 7 + [I] * 5 + [V]
BASELINE_H_VARIANTS = {
    "base": [],
    "copy": [(r"(uint32_t dequant2\(int q0, int q1, float scale\) \{)",
              r"\1\n  return (static_cast<uint32_t>(q0) & 0xffffu) | "
              r"(static_cast<uint32_t>(q1) << 16);")],
}


def build_variants(source: Path, variants: dict, argtypes: list,
                   out_dir: Path, symbol: str) -> dict:
    """Compile each variant (a list of source rewrites) of a kernel source
    in parallel; returns {variant: (ctypes function ``symbol`` taking
    ``argtypes``, ptxas register counts)}. A library is named by source
    stem, symbol and variant, and a path loads once a process: an
    earlier commit's source goes to a ``out_dir`` of its own."""
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
        lib.with_suffix(".log").write_text(out)
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
    if baseline is None:
        return
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    out = torch.empty((tiled.n_rows, F), device=device)
    fns = build_variants(baseline, BASELINE_VARIANTS, BASELINE_C_ARGS,
                         out_dir / "baseline", "tiled_spmm")
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


def b_cases(data, device, seed: int):
    """Kernel B's operands at the widths its callers use: ``(name,
    row_ptr, cols, vals, x, dense, x_bf16, plain)``, ``plain()`` the
    plain version of the same product; x is f32, or bf16 where
    ``x_bf16``."""
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops import spmm_tiled as ti
    from sgc_tpu_torch.ops.spmm import spmm_segment_plain

    graph, feats = data[0], data[1]
    g = graph.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = g.n_cols
    for F in (1, 8, 16, 41, 64):
        x = (torch.ones((n, 1), device=device) if F == 1 else
             torch.randn((n, F), device=device, generator=gen))
        yield (f"shuffled_f{F}", g.row_ptr, g.cols, g.vals, x, None, False,
               lambda x=x: spmm_segment_plain(g, x))
    x = torch.as_tensor(feats, device=device)
    yield ("shuffled_hop_f602", g.row_ptr, g.cols, g.vals, x, None, False,
           lambda: spmm_segment_plain(g, x))
    del g, x
    plan = LocalityPlan.build(*data, formulation="auto", device=device)
    dargs = plan._device_args()[0]
    rest = dargs.rest
    x = torch.as_tensor(plan.features, device=device)
    dense = bd.apply_cells(plan.split_main, dargs, x, "f32")
    yield ("remainder_f602", rest.row_ptr, rest.cols, rest.vals, x, dense,
           False, lambda: spmm_segment_plain(rest, x, dense))
    buf = torch.empty(x.numel() + 1, device=device)
    xo = buf[1:].view_as(x)
    xo.copy_(x)
    yield ("remainder_f602_x_off4", rest.row_ptr, rest.cols, rest.vals, xo,
           dense, False, lambda: spmm_segment_plain(rest, xo, dense))
    del plan, dargs, rest, x, dense, buf, xo
    torch.cuda.empty_cache()
    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    tiled = plan.split_main.tiled
    args = plan._device_args()[0].tiled
    x = torch.as_tensor(plan.features, device=device)
    yield ("kernel_c_f32", args.row_ptr, args.cols, args.vals, x, None,
           False, lambda: ti.spmm_tiled_plain(tiled, x))
    yield ("kernel_c_bf16", args.row_ptr, args.cols, args.vals,
           x.to(torch.bfloat16), None, True,
           lambda: ti.spmm_tiled_plain(tiled, x, "bf16"))


def b_variant_plan(F: int, x_bf16: bool, align: int, overrides: dict):
    from sgc_tpu_torch.ops.spmm import csr_plan

    kw = dict(overrides)
    if kw.get("lanes") == "half":
        kw["lanes"] = max(1, csr_plan(F, x_bf16, align).lanes // 2)
    return csr_plan(F, x_bf16, align, **kw)


def kernel_b(data, device, reps: int, seed: int,
             baseline: Path | None) -> None:
    import torch

    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops.spmm import launch_csr, operand_align

    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "spmm_csr.cu",
                         {k: v[0] for k, v in B_VARIANTS.items()}, CSR_ARGS,
                         out_dir, "csr_spmm")
    base_fn = None
    if baseline is not None:
        base_fn = build_variants(baseline, {"baseline": []},
                                 BASELINE_B_ARGS, out_dir / "baseline",
                                 "csr_spmm")["baseline"][0]
    mismatched = []
    for name, row_ptr, cols, vals, x, dense, x_bf16, plain in b_cases(
            data, device, seed):
        n_rows = int(row_ptr.shape[0]) - 1
        F = int(x.shape[1])
        out = torch.empty((n_rows, F), device=device)
        align = operand_align(x, dense, out)
        deg = row_ptr[1:] - row_ptr[:-1]
        hub = int(deg.argmax())
        nnz = int(row_ptr[-1])
        want = plain()
        results = {}
        for variant, (fn, regs) in fns.items():
            plan = b_variant_plan(F, x_bf16, align, B_VARIANTS[variant][1])
            got = torch.empty_like(out)

            def run(fn=fn, plan=plan, got=got):
                launch_csr(row_ptr, cols, vals, x, dense, got, x_bf16, fn,
                           plan)
            run()
            torch.cuda.synchronize()
            results[variant] = got
            row = {"kernel": "B", "case": name, "variant": variant,
                   "F": F, "plan": plan.args(), "registers": regs,
                   "ms": time_ms(run, reps), "rel_err": rel_err(got, want),
                   "same_bits_as_base": bool(torch.equal(got,
                                                         results["base"]))}
            # the largest row alone: the chain the tail waits for
            h0, h1 = int(row_ptr[hub]), int(row_ptr[hub + 1])
            hub_ptr = torch.tensor([0, h1 - h0], dtype=torch.int32,
                                   device=device)
            hub_out = torch.empty((1, F), device=device)
            hub_dense = None if dense is None else dense[hub:hub + 1]
            row["hub_row_ms"] = time_ms(lambda: launch_csr(
                hub_ptr, cols[h0:h1], vals[h0:h1], x, hub_dense, hub_out,
                x_bf16, fn, plan), reps)
            if variant == "base":
                row.update({
                    "nnz": nnz, "n_rows": n_rows,
                    "max_degree": h1 - h0, "mean_degree": nnz / n_rows,
                    "gathered_gbps": nnz * F * x.element_size()
                    / row["ms"] / 1e6})
            emit(row)
            if not row["same_bits_as_base"]:
                mismatched.append((name, variant))
        if base_fn is not None:
            old = torch.empty_like(out)

            def run_old():
                rc = base_fn(row_ptr.data_ptr(), cols.data_ptr(),
                             vals.data_ptr(), x.data_ptr(),
                             dense.data_ptr() if dense is not None else None,
                             old.data_ptr(), n_rows, F, int(x_bf16),
                             kernels.stream_of(x))
                kernels.check_launch(rc, "baseline csr_spmm")
            run_old()
            torch.cuda.synchronize()
            same = bool(torch.equal(old, results["base"]))
            emit({"kernel": "B", "case": name, "variant": "baseline",
                  "F": F, "ms": time_ms(run_old, reps),
                  "rel_err": rel_err(old, want),
                  "same_bits_as_base": same})
            if not same:
                mismatched.append((name, "baseline"))
            del old
        if not x_bf16:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*[Ss]parse")
                csr = torch.sparse_csr_tensor(
                    row_ptr, cols[:nnz], vals[:nnz], size=(n_rows,
                                                           x.shape[0]),
                    check_invariants=False)
            lib = ((lambda: torch.sparse.mm(csr, x)) if dense is None else
                   (lambda: torch.addmm(dense, csr, x)))
            emit({"kernel": "B", "case": name, "variant": "library",
                  "F": F, "ms": time_ms(lib, reps)})
            del csr
        del results, want, out
        torch.cuda.empty_cache()
    if mismatched:
        raise AssertionError(f"kernel B bits differ: {mismatched}")


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
                                 out_dir / "baseline", "sddmm")["base"][0]
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


def profiled_kernels_ms(fn, calls: int) -> dict:
    """Each CUDA kernel's device time a call of ``fn`` (ms), from
    ``torch.profiler`` over ``calls`` calls after a warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and "CUDA" in str(getattr(ev, "device_type", "")):
            out[ev.key[:60]] = t / 1e3 / calls
    return out


def kernel_g(device, reps: int, baseline: Path | None) -> None:
    import torch

    from sgc_tpu_torch.ops import edge_accumulate as ea
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.scripts import exp_gather_probe as gp

    rows, cols, vals, x = (torch.from_numpy(a).to(device)
                           for a in gp.make_inputs(2048, 2048, 768, 1024, 64))
    R, F, E = 2048, int(x.shape[1]), int(rows.shape[0])
    cyc = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, device=device)
    kernels.check_launch(kernels.entry("edge_accumulate", "edge_chain_cycles")(
        cyc.data_ptr(), sink.data_ptr(), 1 << 20, kernels.stream_of(x)),
        "edge_chain_cycles")
    torch.cuda.synchronize()
    per_add = int(cyc) / (1 << 20)
    emit({"kernel": "G", "fadd_cycles_per_link": per_add,
          "chain_bound_ms_at_1980mhz": rf.chain_bound_ms(E, per_add, 1.98)})
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        csr = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                      vals, (R, x.shape[0])
                                      ).coalesce().to_sparse_csr()
    emit({"kernel": "G", "variant": "library_sparse_mm",
          "ms": time_ms(lambda: torch.sparse.mm(csr, x), reps)})
    del csr
    want = {m: ea.edge_accumulate_plain(rows, cols, vals, x, R, m)
            for m in ea.MODES}
    for m in ea.MODES:
        b = ea.bucket_edges(rows, cols, vals, x, R, m)
        emit({"kernel": "G", "mode": m, "variant": "current",
              "ms": time_ms(lambda: ea.edge_accumulate(rows, cols, vals, x,
                                                       R, m), reps),
              "bucket_ms": time_ms(lambda: ea.bucket_edges(
                  rows, cols, vals, x, R, m), reps),
              "accumulate_ms": time_ms(lambda: ea.accumulate_buckets(
                  b, x, R, m), reps),
              "launches_ms": profiled_kernels_ms(
                  lambda: ea.edge_accumulate(rows, cols, vals, x, R, m), 10),
              "exact": bool(torch.equal(
                  ea.edge_accumulate(rows, cols, vals, x, R, m), want[m]))})
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" /
                         "edge_accumulate.cu", G_VARIANTS, G_ARGS, out_dir,
                         "edge_accumulate")
    out = torch.empty((R, F), device=device)
    bits = dict(ea._MODE_BITS)
    for name, (fn, regs) in fns.items():
        for m in ea.MODES:
            buf, ptrs = ea._scratch(E, R, device)

            def run(fn=fn, m=m, ptrs=ptrs):
                rc = fn(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                        x.data_ptr(), out.data_ptr(), E, R, x.shape[0], F,
                        bits[m], ea.BUCKET_CHUNK, *ptrs,
                        kernels.stream_of(x))
                kernels.check_launch(rc, f"kernel G {name}")
            run()
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, want[m]))
            emit({"kernel": "G", "mode": m, "variant": name,
                  "registers": regs, "ms": time_ms(run, reps),
                  "exact": exact})
            del buf
            if not exact:
                raise AssertionError(f"kernel G {name} {m}: bits differ")
    if baseline is None:
        return
    base_fn = build_variants(baseline, {"baseline": []}, BASELINE_G_ARGS,
                             out_dir / "baseline",
                             "edge_accumulate")["baseline"][0]
    for m in ea.MODES:
        def run_old(m=m):
            rc = base_fn(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                         x.data_ptr(), out.data_ptr(), E, R, x.shape[0], F,
                         256, bits[m], kernels.stream_of(x))
            kernels.check_launch(rc, "baseline edge_accumulate")
        run_old()
        torch.cuda.synchronize()
        emit({"kernel": "G", "mode": m, "variant": "baseline",
              "ms": time_ms(run_old, reps),
              "exact": bool(torch.equal(out, want[m]))})


def kernel_h(data, device, reps: int, baseline: Path | None) -> None:
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import blockdense_int8 as h
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import spmm_blockdense as bd

    plan = LocalityPlan.build(*data, formulation="auto", device=device)
    split, dargs = plan.split_main, plan._device_args()[0]
    x = torch.as_tensor(plan.features, device=device)
    q, scales = h.quantize_cells(dargs.cells)
    cells = h.int8_cells(q, scales, split.rb_ids, split.st_ids,
                         split.n_row_blocks, split.n_stripes)
    del q
    xp = h.pad_x_bf16(x, split.n_stripes * split.stripe, 768)
    f_pad = int(xp.shape[1])
    want = h.apply_cells_int8_plain(cells, xp)
    got = h.apply_cells_int8(cells, xp)
    again = h.apply_cells_int8(cells, xp)
    emit({"kernel": "H", "variant": "current", "cells": split.n_cells,
          "slots": int(cells.cells.shape[0]), "f_pad": f_pad,
          "ms": time_ms(lambda: h.apply_cells_int8(cells, xp), reps),
          "rel_err": rel_err(got, want),
          "identical_launches": bool(torch.equal(got, again))})
    del got, again
    emit({"kernel": "H", "variant": "kernel_a_bf16", "ms": time_ms(
        lambda: bd.apply_cells(split, dargs, x, "bf16"), reps)})
    k_i, r_i, w_i = cells.cells.nonzero(as_tuple=True)
    rb_of = torch.as_tensor(split.rb_ids, device=device).long()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        csr = torch.sparse_coo_tensor(
            torch.stack([rb_of[k_i] * split.row_block + r_i,
                         cells.st_ids.long()[k_i] * split.stripe + w_i]),
            h.dequantize(cells.cells[k_i, r_i, w_i], cells.scales[k_i]),
            (cells.n_rb * split.row_block, xp.shape[0])
        ).coalesce().to_sparse_csr()
    del k_i, r_i, w_i
    xpf = xp.float()
    zero = xpf.new_zeros((csr.shape[0], f_pad))
    emit({"kernel": "H", "variant": "library_addmm", "ms": time_ms(
        lambda: torch.addmm(zero, csr, xpf, beta=0.0), reps)})
    del csr, xpf, zero
    out = torch.empty_like(want)
    R, W = cells.row_block, cells.stripe
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" /
                         "blockdense_int8.cu", H_VARIANTS, H_ARGS, out_dir,
                         "blockdense_int8_cells")
    common = (cells.cells.data_ptr(), cells.scales.data_ptr(),
              xp.data_ptr(), out.data_ptr(), cells.rb_ptr.data_ptr(),
              cells.cell_of.data_ptr(), cells.st_ids.data_ptr())
    for name, (fn, regs) in fns.items():
        def run(fn=fn):
            rc = fn(*common, int(cells.cells.shape[0]), cells.n_rb,
                    cells.n_st, f_pad, R, W, kernels.stream_of(xp))
            kernels.check_launch(rc, f"kernel H {name}")
        run()
        torch.cuda.synchronize()
        err = rel_err(out, want)
        emit({"kernel": "H", "variant": name, "registers": regs,
              "ms": time_ms(run, reps), "rel_err": err,
              "timing_only": name in H_TIMING_ONLY})
        if name not in H_TIMING_ONLY | {"row_block_sum"} and not err <= 1e-5:
            raise AssertionError(f"kernel H {name}: rel err {err:.3e}")
    if baseline is not None:
        old = build_variants(baseline, BASELINE_H_VARIANTS, BASELINE_H_ARGS,
                             out_dir / "baseline", "blockdense_int8_cells")
        for name, (fn, regs) in old.items():
            def run_old(fn=fn):
                rc = fn(*common, cells.n_rb, cells.n_st, f_pad, R, W,
                        kernels.stream_of(xp))
                kernels.check_launch(rc, f"baseline H {name}")
            run_old()
            torch.cuda.synchronize()
            emit({"kernel": "H", "variant": f"baseline_{name}",
                  "registers": regs, "ms": time_ms(run_old, reps),
                  "rel_err": rel_err(out, want),
                  "timing_only": name == "copy"})
    # the same index over random dense cells: each output a long sum
    g = torch.Generator(device=device).manual_seed(0)
    rand = h.int8_cells(
        torch.randint(-127, 128, tuple(cells.cells.shape), dtype=torch.int8,
                      device=device, generator=g),
        torch.rand(cells.cells.shape[0], device=device, generator=g) / 64,
        split.rb_ids, split.st_ids, cells.n_rb, cells.n_st)
    want_rand = h.apply_cells_int8_plain(rand, xp)
    for name in ("base", "row_block_sum"):
        fn = fns[name][0]
        rc = fn(rand.cells.data_ptr(), rand.scales.data_ptr(), xp.data_ptr(),
                out.data_ptr(), rand.rb_ptr.data_ptr(),
                rand.cell_of.data_ptr(), rand.st_ids.data_ptr(),
                int(rand.cells.shape[0]), rand.n_rb, rand.n_st, f_pad, R, W,
                kernels.stream_of(xp))
        kernels.check_launch(rc, f"kernel H {name}")
        torch.cuda.synchronize()
        emit({"kernel": "H", "variant": name, "cells": "random_dense",
              "rel_err": rel_err(out, want_rand)})
    del rand, want_rand


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default="a,b,c,d,g,h",
                    help="comma-separated kernels to run")
    ap.add_argument("--baseline-b", type=Path, default=None)
    ap.add_argument("--baseline-c", type=Path, default=None)
    ap.add_argument("--baseline-d", type=Path, default=None)
    ap.add_argument("--baseline-g", type=Path, default=None)
    ap.add_argument("--baseline-h", type=Path, default=None)
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
    chosen = set(args.kernels.split(","))
    kernels.build_all(kernels.KERNEL_SOURCES + tuple(
        n for k, n in (("g", "edge_accumulate"), ("h", "blockdense_int8"))
        if k in chosen))
    data = synthetic_reddit_clustered(args.scale, seed=args.seed,
                                      shuffle=True)
    if "a" in chosen:
        kernel_a(data, device, args.reps)
    if "b" in chosen:
        kernel_b(data, device, args.reps, args.seed, args.baseline_b)
    if "c" in chosen:
        kernel_c(data, device, args.reps, args.baseline_c)
    if "d" in chosen:
        kernel_d(data, device, args.reps, args.baseline_d)
    if "g" in chosen:
        kernel_g(device, args.reps, args.baseline_g)
    if "h" in chosen:
        kernel_h(data, device, args.reps, args.baseline_h)
    return 0


if __name__ == "__main__":
    sys.exit(main())
