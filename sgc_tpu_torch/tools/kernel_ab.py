#!/usr/bin/env python3
"""CUDA-event A/B runs of the port's kernels A-H on one card, at the chip
smoke's full-scale clustered-Reddit splits (E, F and G at the probes'
defaults).

    python3 -m sgc_tpu_torch.tools.kernel_ab [--scale 1.0] [--reps 5]
        [--kernels a,b,b_order,c,d,edge_softmax,e,f,g,h]

Kernel E (``csrc/probe_copy.cu``) at the probes' shapes ((8, 128) and 8
blocks of (8, 128)), launch-bound: the launch floor (an empty kernel,
``probe_launch_floor``: ``E_CALLS`` launches inside one C call, and one
launch a call through the port's Python path), the host path split
into its steps (each alone over ``SPLIT_CALLS`` calls on the host clock:
the output's allocation, the raw stream against PyTorch's ``Stream``
object, the ctypes call with and without a launch, the checks, the
whole wrapper, ``torch.mul``), then each entry over ``E_CALLS`` calls
in turns with ``torch.mul(x, 2.0)``, each with its mean device time a
launch under ``torch.profiler`` (``profiled_launch_ms``); every result
must equal the plain version's bits.

Kernel F (``csrc/row_gather.cu``) at the take probe's shape (65,536 rows
of a 2,048 x 768 table) and the DMA probe's (64 rows of 1,024 x 256):
the byte bound, the launch floor, the write ceiling (``zero_()`` on the
output, the card's rate for pure writes) and ``torch.index_select``
first, then every entry and depth through the wrapper, each path alone
under its ``gather_plan`` (the 4-byte load and ``cp.async`` paths forced
on the aligned table) and variants made by rewriting the source
(``F_LOAD_VARIANTS``, ``F_ASYNC_VARIANTS``: no L2 policies, loads at
evict_normal, no proxy fence, other vectors a lane and CTAs an SM),
each with its mean device time a launch and exact bits.

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
must give the base kernel's bits.

Kernel B's row order (``b_order``) on GCNII's operator (``(1 - alpha) S``
at alpha 0.1 on the shuffled graph): the locality measure in the graph's
ids and in LPA's order (``graph/reorder.py::block_share``), LPA's and the
permuted copy's build times, whether the operator's preparation
(``ops/autograd.py::prepare_operator``) gives it a walk and its time, and
whether a launch walks it at F = 8, 41 and 64 (``ops/spmm.py::row_walk``,
the L2 rule); then kernel B at F = 64 with GCNII's dense operand, and at F
= 41, 8 and 602 (a plain hop) without, in four forms, each in index
CTA order and with
``heavy_first``'s: (a) the graph's ids; (b) the same operator relabelled
in LPA's order, rows and columns, x and the dense operand permuted (the
ceiling of the order); (c) (b)'s rows with the graph's column ids and the
row map, the product in the graph's rows (the design); (c0) as (c) with
the output left in walked order (no row map). Each form's bits must
equal (a)'s, row for row.

Kernel C: the current kernel (``csrc/spmm_csr.cu`` on the layout's edges
re-sorted by row) on the onehot main and last-hop splits, beside
``torch.addmm`` over the main split's slots as one coalesced CSR matrix
(its variants are kernel B's, on kernel C's operand).

Kernel A: ``apply_cells`` on the block-dense main split at both
precisions, each with its error against the plain f32 product and the
plain product on bf16(x), and variants of the kernel made by rewriting
its source (``A_VARIANTS``), among them a third bf16 term of x at
``"f32"``.

Kernel D (``csrc/sddmm.cu``) at the widths its callers use
(``d_cases``): GAT's per-head backward at F = 8 and 41 on the shuffled
Reddit-shape graph (a = a contiguous gradient, b = one head's slice of a
stacked ``(H, n, F)`` tensor: at F = 41 an odd head's rows are 4 bytes
off, as in ``models/gat.py::multi_head_gat``), and F = 602 on the main
operator in its LPA order and in its shuffled order (a = the features,
b = one hop of them), each at both precisions. Each case prints the
kernel's plan, its error against the plain version, whether two
launches give the same bits, its time, the byte bound, the library call
(``torch.sparse.sampled_addmm``; at ``"bf16"`` on copies rounded to
bf16 outside the timed call) and the wrapper's bf16 copy of b alone.
Variants (``D_VARIANTS``: source rewrites and the plan's overrides:
lanes per edge, edges per warp, and for a warp that is one lane group
its edges in flight and edges per warp) are each held to the plain
version.

GAT's attention entries (``edge_softmax``, ``csrc/edge_softmax.cu``) on
the shuffled Reddit-shape graph, each function of ``ops/edge_softmax.py``
alone (the scores, the softmax, its backward, the scores' backward: its
row sums with the scattered terms, then the column sums; five launches a
head and layer), from node scores ``h @ a`` of a head at GAT's two widths
(F = 8 and 41; the entries' work does not depend on F, only the values
do): each prints its time, its byte bound (``ops/roofline.py``, at
the least bytes the function needs), its bits against the plain
version's (the composition of PyTorch ops and kernel B's F = 1 sums it
replaces), whether two launches agree, and the plain composition's
time, timed first, each also as its kernels' device time under
``torch.profiler``; the softmax also beside ``torch.sparse.softmax`` on
the logits as a COO matrix, the one library call that computes it (its
time and its values' largest gap to the kernel's); then the five
together against the five plain versions.

Kernel G (``csrc/edge_accumulate.cu``) on the gather probe's edges
(65,536 into 2,048 x 768) in every mode: the whole call, the bucket pass
and the accumulate pass alone, each launch's device time under
``torch.profiler``, the FADD chain's cycles a link, ``torch.sparse.mm``
on the same edges, and variants made by rewriting the source
(``G_VARIANTS``: the light rows' slice width, edges read at once and CTA
size, their x slice read from global memory, the heavy ring's depth and
4-byte copies, ``__match_any_sync`` for the bucket pass's ranks); every
variant must give the plain version's bits.

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
split's index, where a long f32 sum shows its rounding.

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

V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entries' argument types
CSR_ARGS = [V] * 6 + [I] * 9 + [V] * 3
A_ARGS = [V] * 7 + [I] * 9 + [V]
D_ARGS = [V] * 5 + [L, L] + [I] * 11 + [V]

# variants of kernel D: (source rewrites, the plan's overrides) — lanes
# per edge (a lane holding 16 bytes of b a pass; half and twice the
# plan's lanes); 64 edges a warp for lane groups; for the warp that is
# one lane group (32 lanes an edge): 2 or 8 edges a batch, 32 or 128
# edges a warp
D_VARIANTS = {
    "base": ([], {}),
    "lane_bytes16": ([], {"lane_bytes": 16}),
    "lanes_half": ([], {"lanes": "half"}),
    "lanes_twice": ([], {"lanes": "twice"}),
    "seg64": ([(r"SEG_EDGES = 256;", "SEG_EDGES = 64;")], {"seg_edges": 64}),
    "hold_unroll2": ([(r"HOLD_UNROLL = 4;", "HOLD_UNROLL = 2;")],
                     {"hold_unroll": 2}),
    "hold_unroll8": ([(r"HOLD_UNROLL = 4;", "HOLD_UNROLL = 8;")],
                     {"hold_unroll": 8}),
    "hold_seg32": ([(r"HOLD_SEG_EDGES = 64;", "HOLD_SEG_EDGES = 32;")],
                   {"hold_seg_edges": 32}),
    "hold_seg128": ([(r"HOLD_SEG_EDGES = 64;", "HOLD_SEG_EDGES = 128;")],
                    {"hold_seg_edges": 128}),
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


def build_variants(source: Path, variants: dict, argtypes: list,
                   out_dir: Path, symbol: str) -> dict:
    """Compile each variant (a list of source rewrites) of a kernel source
    in parallel; returns {variant: (ctypes function ``symbol`` taking
    ``argtypes``, ptxas register counts)}. A library is named by source
    stem, symbol and variant, and a path loads once a process."""
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


def kernel_c(data, device, reps: int) -> None:
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
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


def kernel_b(data, device, reps: int, seed: int) -> None:
    import torch

    from sgc_tpu_torch.ops.spmm import launch_csr, operand_align

    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "spmm_csr.cu",
                         {k: v[0] for k, v in B_VARIANTS.items()}, CSR_ARGS,
                         out_dir, "csr_spmm")
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


def kernel_b_orders(data, device, reps: int, seed: int) -> None:
    import time

    import numpy as np
    import scipy.sparse as sp

    import torch

    from sgc_tpu_torch.graph import reorder
    from sgc_tpu_torch.graph.sparse import host
    from sgc_tpu_torch.ops import spmm as sm
    from sgc_tpu_torch.ops.autograd import prepare_operator

    g0 = data[0].to(device)
    g = g0.with_vals(g0.vals * 0.9)
    del g0
    n, nnz = g.n_rows, g.nnz
    t0 = time.perf_counter()
    order = torch.as_tensor(reorder.lpa_order(sp.csr_matrix(
        (np.ones(nnz, np.float32), host(g.cols)[:nnz], host(g.row_ptr)),
        shape=g.shape)), device=device)
    lpa_s = time.perf_counter() - t0
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = sm.walk_rows(g, order)
    ptr, cols, vals, row_map = (walk.row_ptr, walk.cols, walk.vals,
                                walk.row_map)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = prepare_operator(g)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    rows, gcols = g.rows[:nnz], g.cols[:nnz]
    emit({"kernel": "B", "case": "row_order", "n": n, "nnz": nnz,
          "l2_bytes": sm.l2_bytes(device), "block": reorder.ORDER_BLOCK,
          "share_ids": reorder.block_share(rows, gcols),
          "share_lpa": reorder.block_share(rows, gcols, pos), "lpa_s": lpa_s,
          "walk_s": walk_s, "prepare_s": prepare_s,
          "prepared_walk": prepared.walk is not None,
          "engaged": {F: sm.row_walk(prepared, F) is not None
                      for F in (8, 41, 64)}})
    del prepared
    cols_b = pos.index_select(0, cols.long()).to(torch.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    mismatched = []
    for F in (64, 41, 8, 602):
        x = torch.randn((n, F), device=device, generator=gen)
        dense = (torch.randn((n, F), device=device, generator=gen)
                 if F == 64 else None)
        xb = x.index_select(0, order)
        db = None if dense is None else dense.index_select(0, order)
        want = torch.empty((n, F), device=device)
        plan = sm.csr_plan(F, False, sm.operand_align(x, dense, want))
        sm.launch_csr(g.row_ptr, g.cols, g.vals, x, dense, want, plan=plan)
        walked_want = want.index_select(0, order)
        heavy = {"a": sm.heavy_first(g.row_ptr, n, plan.rows_per_cta)}
        heavy["b"] = heavy["c"] = heavy["c0"] = sm.heavy_first(
            ptr, n, plan.rows_per_cta)
        forms = {"a": (g.row_ptr, g.cols, g.vals, x, dense, None, want),
                 "b": (ptr, cols_b, vals, xb, db, None, walked_want),
                 "c": (ptr, cols, vals, x, dense, row_map, want),
                 "c0": (ptr, cols, vals, x, db, None, walked_want)}
        for form, (p_, c_, v_, x_, d_, m_, ref) in forms.items():
            for cta in (None, heavy[form]):
                out = torch.empty((n, F), device=device)

                def run(p_=p_, c_=c_, v_=v_, x_=x_, d_=d_, m_=m_, out=out,
                        cta=cta):
                    sm.launch_csr(p_, c_, v_, x_, d_, out, plan=plan,
                                  cta_order=cta, row_map=m_)
                run()
                torch.cuda.synchronize()
                same = bool(torch.equal(out, ref))
                ms = time_ms(run, reps)
                emit({"kernel": "B", "case": f"gcnii_f{F}", "form": form,
                      "dense": dense is not None,
                      "cta_order": cta is not None, "ms": ms,
                      "gathered_tbps": nnz * F * 4 / ms / 1e9,
                      "same_bits_as_index": same})
                if not same:
                    mismatched.append((F, form, cta is not None))
        del x, dense, xb, db, want, walked_want
        torch.cuda.empty_cache()
    if mismatched:
        raise AssertionError(f"kernel B row order bits differ: {mismatched}")


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


def d_cases(data, device, seed: int):
    """Kernel D's operands at the widths its callers use: ``(name, graph,
    a, b)`` on the card."""
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm as sp

    gen = torch.Generator(device=device).manual_seed(seed)
    g = data[0].to(device)
    for F in (8, 41):
        # one head's slice of the stacked (H, n, F) projection: head 1, so
        # at F = 41 its rows start 4 bytes off (n is odd)
        hs = torch.randn((8, g.n_cols, F), device=device, generator=gen)
        a = torch.randn((g.n_rows, F), device=device, generator=gen)
        yield f"gat_shuffled_f{F}", g, a, hs[1]
        del hs, a
    x = torch.as_tensor(data[1], device=device)
    yield "shuffled_f602", g, x, sp.spmm_segment(g, x)
    del g, x
    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    g = plan.graph.to(device)
    x = torch.as_tensor(plan.features, device=device)
    del plan
    yield "lpa_f602", g, x, sp.spmm_segment(g, x)


def d_variant_plan(F: int, precision: str, align: int, overrides: dict):
    from sgc_tpu_torch.ops.spmm import sddmm_plan

    kw = dict(overrides)
    base = sddmm_plan(F, precision, align).lanes
    if kw.get("lanes") == "half":
        kw["lanes"] = max(1, base // 2)
    elif kw.get("lanes") == "twice":
        kw["lanes"] = min(32, base * 2)
    return sddmm_plan(F, precision, align, **kw)


def kernel_d(data, device, reps: int, seed: int) -> None:
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm as sp

    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    built = {k: v[0] for k, v in D_VARIANTS.items() if k == "base" or v[0]}
    fns = build_variants(ROOT / "sgc_tpu_torch" / "csrc" / "sddmm.cu", built,
                         D_ARGS, out_dir, "sddmm")
    mismatched = []
    for name, g, a, b in d_cases(data, device, seed):
        F = int(a.shape[1])
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*[Ss]parse")
            csr = torch.sparse_csr_tensor(
                g.row_ptr, g.cols[:g.nnz], g.vals[:g.nnz],
                size=(g.n_rows, g.n_cols), check_invariants=False)
        for p in sp.PRECISIONS:
            want = sp.sddmm_plain(g, a, b, p)
            bk, _ = sp._kernel_copy(b, p)
            align = sp.operand_align(a, bk)
            b_ms, b_by, _, nbytes = rf.sddmm_bound(g, F, 2 if p == "bf16"
                                                   else 4)
            for variant, (_, over) in D_VARIANTS.items():
                fn = fns[variant if variant in fns else "base"]
                plan = d_variant_plan(F, p, align, over)

                def run(fn=fn[0], plan=plan):
                    return sp._sddmm_cuda(g, a, b, p, fn, plan)
                got, again = run(), run()
                torch.cuda.synchronize()
                row = {"kernel": "D", "case": name, "variant": variant,
                       "precision": p, "F": F, "plan": plan.args(),
                       "registers": fn[1], "ms": time_ms(run, reps),
                       "rel_err": rel_err(got, want),
                       "same_bits_twice": bool(torch.equal(got, again)),
                       "padding_zero": not bool(got[g.nnz:].any())}
                if variant == "base":
                    row.update({"nnz": g.nnz, "bound_ms": b_ms,
                                "bound_by": b_by,
                                "achieved_gbps": nbytes / row["ms"] / 1e6})
                emit(row)
                if not (row["rel_err"] <= 1e-5 and row["same_bits_twice"]
                        and row["padding_zero"]):
                    mismatched.append((name, p, variant))
                del got, again
            if p == "bf16":
                ac, bct = sp.bf16_round(a), sp.bf16_round(b).t()
                emit({"kernel": "D", "case": name, "variant": "bf16_copy_b",
                      "F": F, "ms": time_ms(lambda: sp._kernel_copy(b, p),
                                            reps)})
            else:
                ac, bct = a, b.t()
            emit({"kernel": "D", "case": name, "variant": "library",
                  "precision": p, "F": F, "ms": time_ms(
                      lambda: torch.sparse.sampled_addmm(csr, ac, bct,
                                                         beta=0.0), reps)})
            del want, bk, ac, bct
        del csr, g, a, b
        torch.cuda.empty_cache()
    if mismatched:
        raise AssertionError(f"kernel D off its plain version: {mismatched}")


# the C entries each function of ops/edge_softmax.py launches
ENTRIES_OF = {"edge_scores": ["edge_scores"],
              "edge_softmax": ["edge_softmax"],
              "edge_softmax_grad": ["edge_softmax_grad"],
              "edge_scores_grad": ["edge_scores_grad_dst",
                                   "edge_scores_grad_src"]}


def sparse_softmax_call(g, logits):
    """``torch.sparse.softmax`` over the rows of the logits as a COO
    matrix of ``g``'s pattern (the one library call that computes
    ``edge_softmax``), and its values' gap to ``alpha``: ``(call,
    gap)``."""
    import torch

    idx = torch.stack([g.rows[: g.nnz], g.cols[: g.nnz]]).long()
    coo = torch.sparse_coo_tensor(idx, logits[: g.nnz],
                                  (g.n_rows, g.n_cols),
                                  check_invariants=False).coalesce()

    def call():
        return torch.sparse.softmax(coo, dim=1)

    def gap(alpha):
        return float((call().values() - alpha[: g.nnz]).abs().max())

    return call, gap


def kernel_edge_softmax(data, device, reps: int, seed: int) -> None:
    import torch

    from sgc_tpu_torch.ops import edge_softmax as es
    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops.autograd import transpose_places

    g = data[0].to(device)
    places = transpose_places(g)
    gen = torch.Generator(device=device).manual_seed(seed)
    mismatched = []
    for F in (8, 41):
        h = torch.randn((g.n_rows, F), device=device, generator=gen)
        a = 0.1 * torch.randn((2, F), device=device, generator=gen)
        dst, src = (h @ a[0]).contiguous(), (h @ a[1]).contiguous()
        logits, mask = es.edge_scores(g, dst, src, 0.2)
        alpha = es.edge_softmax(g, logits)
        gr = torch.randn(g.n_edges_padded, device=device, generator=gen)
        gr[g.nnz:] = 0.0
        d = es.edge_softmax_grad(g, alpha, gr)
        calls = {"edge_scores": (g, dst, src, 0.2),
                 "edge_softmax": (g, logits),
                 "edge_softmax_grad": (g, alpha, gr),
                 "edge_scores_grad": (g, d, mask, 0.2, places)}
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "device_ms": 0.0, "plain_device_ms": 0.0}
        for fname, args in calls.items():
            fn, plain = getattr(es, fname), getattr(es, fname + "_plain")
            plain_ms = time_ms(lambda: plain(*args), reps)
            got, again, want = (t if isinstance(t, tuple) else (t,) for t
                                in (fn(*args), fn(*args), plain(*args)))
            torch.cuda.synchronize()
            b_ms, _, _, b_bytes = rf.edge_softmax_bound(g, fname)
            row = {"kernel": "edge_softmax", "entry": fname,
                   "launches": ENTRIES_OF[fname], "F": F, "nnz": g.nnz,
                   "ms": time_ms(lambda: fn(*args), reps),
                   "bound_ms": b_ms, "bound_by": "bytes",
                   "plain_ms": plain_ms,
                   "same_bits_as_plain": all(map(torch.equal, got, want)),
                   "same_bits_twice": all(map(torch.equal, got, again))}
            row["achieved_gbps"] = b_bytes / row["ms"] / 1e6
            # device time alone, each launch's: at this size a call's host
            # path is comparable to its kernels' time
            per = profiled_kernels_ms(lambda: fn(*args), reps)
            row["device_ms"] = sum(per.values())
            row["device_ms_by_kernel"] = per
            row["plain_device_ms"] = sum(profiled_kernels_ms(
                lambda: plain(*args), reps).values())
            if fname == "edge_softmax":
                lib, gap = sparse_softmax_call(g, logits)
                row["library"] = "torch.sparse.softmax (COO, dim=1)"
                row["library_ms"] = time_ms(lib, reps)
                row["library_device_ms"] = sum(
                    profiled_kernels_ms(lib, reps).values())
                row["library_max_abs_gap"] = gap(got[0])
                del lib
            emit(row)
            for k in total:
                total[k] += row[k]
            if not (row["same_bits_as_plain"] and row["same_bits_twice"]):
                mismatched.append((fname, F))
            del got, again, want
        emit({"kernel": "edge_softmax", "entry": "all five", "F": F,
              **total})
        del h, dst, src, logits, mask, alpha, gr, d
    if mismatched:
        raise AssertionError(f"edge_softmax off its plain version: "
                             f"{mismatched}")


def _profiled(fn, calls: int) -> list:
    """``(kernel, device ms in all, launches recorded)`` of every CUDA
    kernel ``torch.profiler`` saw over ``calls`` calls of ``fn`` after a
    warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and "CUDA" in str(getattr(ev, "device_type", "")):
            out.append((ev.key[:60], t / 1e3, ev.count))
    return out


def profiled_kernels_ms(fn, calls: int) -> dict:
    """Each CUDA kernel's device time a call of ``fn`` (ms), from
    ``torch.profiler`` over ``calls`` calls after a warm one."""
    return {key: ms / calls for key, ms, _ in _profiled(fn, calls)}


def profiled_launch_ms(fn, calls: int) -> dict:
    """Each CUDA kernel's mean device time a launch (ms) and the launches
    ``torch.profiler`` recorded over ``calls`` calls of ``fn``: the mean
    stays right when the profiler records fewer launches than ran (in a
    long process it has kept one launch in ten)."""
    return {key: {"ms": ms / n, "launches": n}
            for key, ms, n in _profiled(fn, calls) if n}


def kernel_g(device, reps: int) -> None:
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


# kernels E and F: the probes' shapes, the calls timed back to back
E_CALLS = 2000
SPLIT_CALLS = 10000
TAKE_SHAPE = {"wcols": 2048, "f": 768, "chunk": 1024, "chunks": 64}
F_CALLS = 200


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls in a row
    (``time.perf_counter``, the card drained before and after)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launch_floor(x) -> dict:
    """The cost of one launch of an empty kernel (``probe_copy.cu``'s
    ``probe_launch_floor``): (a) ``E_CALLS`` launches inside one C call,
    device time a launch (CUDA events) and host time a launch; (b) one
    launch a call through the port's Python path (the stream, the ctypes
    call, the return code), CUDA-event time a call."""
    import torch

    from sgc_tpu_torch.ops import kernels

    floor = kernels.entry("probe_copy", "probe_launch_floor")
    stream = kernels.stream_of(x)

    def in_c():
        kernels.check_launch(floor(E_CALLS, stream), "probe_launch_floor")

    def per_call():
        rc = floor(1, kernels.stream_of(x))
        if rc:
            kernels.check_launch(rc, "probe_launch_floor")
    in_c()
    torch.cuda.synchronize()
    return {"in_one_c_call_ms": time_ms(in_c, 3) / E_CALLS,
            "in_one_c_call_host_us": host_us(in_c, 3) / E_CALLS,
            "per_python_call_ms": time_ms(per_call, E_CALLS)}


def host_split(x) -> dict:
    """Kernel E's host path at ``x``, each step alone over ``SPLIT_CALLS``
    calls (host microseconds a call): the output's allocation, the raw
    stream, the ``Stream`` object PyTorch's ``current_stream`` builds, the
    ctypes call with no launch and with one empty launch, the operand
    checks, the whole wrapper and ``torch.mul``."""
    import torch

    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops import probe_copy as pe

    floor = kernels.entry("probe_copy", "probe_launch_floor")
    stream = kernels.stream_of(x)
    steps = {
        "empty_like": lambda: torch.empty_like(x),
        "stream_of": lambda: kernels.stream_of(x),
        "current_stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "entry_lookup": lambda: kernels.entry("probe_copy", "probe_scale2"),
        "ctypes_call": lambda: floor(0, stream),
        "ctypes_empty_launch": lambda: floor(1, stream),
        "checks": lambda: kernels.require_cuda_f32(x, "x"),
        "scale2_wrapper": lambda: pe.scale2(x),
        "torch_mul": lambda: torch.mul(x, 2.0),
    }
    return {k: host_us(fn, SPLIT_CALLS) for k, fn in steps.items()}


def kernel_e(device) -> None:
    import torch

    from sgc_tpu_torch.ops import probe_copy as pe
    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.scripts import exp_pallas_probe2 as p2

    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    sx, sel = p2.make_inputs(device)
    floor = launch_floor(x)
    emit({"kernel": "E", "launch_floor": floor})
    emit({"kernel": "E", "host_split_us": host_split(x)})
    cases = {"scale2": (lambda: pe.scale2(x), lambda: pe.scale2_plain(x),
                        lambda: torch.mul(x, 2.0),
                        rf.copy_bound(x.numel(), x.numel(), 0, 1,
                                      floor["per_python_call_ms"])),
             "select_blocks": (
                 lambda: pe.select_blocks(sx, sel, p2.B),
                 lambda: pe.select_blocks_plain(sx, sel, p2.B), None,
                 rf.copy_bound(int(torch.unique(sel).numel()) * p2.B
                               * sx.shape[1], sel.numel() * p2.B
                               * sx.shape[1], sel.numel(), 1,
                               floor["per_python_call_ms"]))}
    for name, (fn, plain, lib, bound) in cases.items():
        want = plain()
        runs = {"current": fn}
        if lib is not None:
            runs["library"] = lib
        for k, run in runs.items():
            if not torch.equal(run(), want):
                raise AssertionError(f"kernel E {name} {k}: bits differ")
        # in turns, over E_CALLS calls each: a, b, c, c, b, a
        order = list(runs) + list(reversed(runs))
        turns = {k: [] for k in runs}
        for k in order:
            turns[k].append(time_ms(runs[k], E_CALLS))
        emit({"kernel": "E", "entry": name, "ms_turns": turns,
              "device_ms": {k: profiled_launch_ms(runs[k], 200)
                            for k in runs if k != "library"},
              **bound, "exact": True})


# variants of kernel F: no L2 policies (evict_normal loads, plain stores,
# bulk copies without hints), evict_normal loads beside the streaming
# stores, the bulk path without its proxy fence, and
# the load path's vectors a lane and CTAs an SM ({variant: (rewrites,
# gather_plan overrides)})
F_LOAD_VARIANTS = {
    "base": ([], {}),
    "no_l2_hints": ([(r"L2::evict_last\.b64", "L2::evict_normal.b64"),
                     (r"__stcs\(out \+ \(row0 \+ u\) \* w \+ \(p - u \* w\), "
                      r"v\[k\]\);",
                      "out[(row0 + u) * w + (p - u * w)] = v[k];")],
                    {}),
    "no_evict_last": ([(r"L2::evict_last\.b64", "L2::evict_normal.b64")],
                      {}),
    "k4_ctas8": ([(r"LOAD_MIN_CTAS = 4;", "LOAD_MIN_CTAS = 8;"),
                  (r"LOAD_K = 8;", "LOAD_K = 4;")],
                 {"load_k": 4, "load_ctas": 8}),
    "k16_ctas2": ([(r"LOAD_MIN_CTAS = 4;", "LOAD_MIN_CTAS = 2;"),
                   (r"LOAD_K = 8;", "LOAD_K = 16;")],
                  {"load_k": 16, "load_ctas": 2}),
}
F_ASYNC_VARIANTS = {
    "base": [],
    "no_l2_hints": [(r"L2::evict_last\.b64", "L2::evict_normal.b64"),
                    (r"L2::evict_first\.b64", "L2::evict_normal.b64")],
    "no_proxy_fence": [(r"      proxy_fence\(\);\n", "")],
}
F_ARGS = {"row_gather_load": [V, V, V, L] + [I] * 6 + [V],
          "row_gather_async": [V, V, V, L] + [I] * 7 + [V]}


def kernel_f(device) -> None:
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import row_gather as rg
    from sgc_tpu_torch.scripts import exp_dma_gather_probe as dp
    from sgc_tpu_torch.scripts import exp_take_probe as tp

    shapes = {"take": [torch.from_numpy(a).to(device)
                       for a in tp.make_inputs(**TAKE_SHAPE)],
              "dma": [torch.from_numpy(a).to(device)
                      for a in dp.make_inputs()]}
    floor = launch_floor(shapes["dma"][0])
    emit({"kernel": "F", "launch_floor": floor})
    out_dir = ROOT / "build" / "sgc_tpu_torch" / "ab"
    src = ROOT / "sgc_tpu_torch" / "csrc" / "row_gather.cu"
    load_fns = build_variants(src, {k: v[0] for k, v in
                                    F_LOAD_VARIANTS.items()},
                              F_ARGS["row_gather_load"], out_dir,
                              "row_gather_load")
    async_fns = build_variants(src, F_ASYNC_VARIANTS,
                               F_ARGS["row_gather_async"], out_dir,
                               "row_gather_async")
    sms = rg.sms_of(shapes["take"][0])
    for shape, (x, idx) in shapes.items():
        calls = F_CALLS if shape == "take" else E_CALLS
        want = rg.row_gather_plain(x, idx)
        n_out, F = int(idx.numel()), int(x.shape[1])
        bound = rf.bound_ms(*rf.copy_count(
            int(torch.unique(idx).numel()) * F, n_out * F, n_out))[0]
        out = torch.empty_like(want)
        idx64 = idx.long()
        emit({"kernel": "F", "shape": shape, "bound_ms": bound,
              "launch_floor_ms": floor["per_python_call_ms"],
              "write_ceiling_ms": time_ms(out.zero_, calls),
              "library_ms": time_ms(lambda: torch.index_select(x, 0, idx64),
                                    calls)})

        def record(name, variant, fn, exact, regs=None):
            ms = time_ms(fn, calls)
            emit({"kernel": "F", "shape": shape, "entry": name,
                  "variant": variant, "registers": regs, "ms": ms,
                  "bound_share": bound / ms,
                  "device_ms": profiled_launch_ms(fn, 20), "exact": exact})
            if not exact:
                raise AssertionError(f"kernel F {name} {variant} {shape}: "
                                     "bits differ")

        # the wrappers, as the probes call them
        runs = {"load": lambda: rg.row_gather(x, idx, "load")}
        runs.update({f"async_{n}": (lambda n=n: rg.row_gather(x, idx,
                                                               "async", n))
                     for n in rg.IN_FLIGHT})
        for name, fn in runs.items():
            record(name, "current", fn, bool(torch.equal(fn(), want)))
        # each path alone under its plan: the 4-byte paths forced on the
        # aligned operands, and every variant
        plans = {"load_scalar": (None, rg.gather_plan(
                     n_out, F, "load", aligned=False, sms=sms)),
                 "cp_async_8": (None, rg.gather_plan(
                     n_out, F, "async", 8, aligned=False, sms=sms))}
        for v, (_, over) in F_LOAD_VARIANTS.items():
            plans[f"load/{v}"] = (load_fns[v], rg.gather_plan(
                n_out, F, "load", sms=sms, **over))
        for v in F_ASYNC_VARIANTS:
            for n in (8, 16):
                plans[f"async_{n}/{v}"] = (async_fns[v], rg.gather_plan(
                    n_out, F, "async", n, sms=sms))
        for name, (lib, plan) in plans.items():
            fn_regs = lib or (None, None)

            def run(plan=plan, lib=fn_regs[0]):
                rg.launch_gather(x, idx, out, plan, lib)
            out.zero_()
            run()
            torch.cuda.synchronize()
            emit({"kernel": "F", "shape": shape, "entry": name,
                  "plan": plan.__dict__})
            record(name, "plan", run, bool(torch.equal(out, want)),
                   fn_regs[1])


def kernel_h(data, device, reps: int) -> None:
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
    ap.add_argument("--kernels",
                    default="a,b,b_order,c,d,edge_softmax,e,f,g,h",
                    help="comma-separated kernels to run")
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
        n for k, n in (("e", "probe_copy"), ("f", "row_gather"),
                       ("g", "edge_accumulate"), ("h", "blockdense_int8"))
        if k in chosen))
    if "e" in chosen:
        kernel_e(device)
    if "f" in chosen:
        kernel_f(device)
    if not chosen & {"a", "b", "b_order", "c", "d", "edge_softmax", "h"}:
        return 0
    data = synthetic_reddit_clustered(args.scale, seed=args.seed,
                                      shuffle=True)
    if "a" in chosen:
        kernel_a(data, device, args.reps)
    if "b" in chosen:
        kernel_b(data, device, args.reps, args.seed)
    if "b_order" in chosen:
        kernel_b_orders(data, device, args.reps, args.seed)
    if "c" in chosen:
        kernel_c(data, device, args.reps)
    if "d" in chosen:
        kernel_d(data, device, args.reps, args.seed)
    if "edge_softmax" in chosen:
        kernel_edge_softmax(data, device, args.reps, args.seed)
    if "g" in chosen:
        kernel_g(device, args.reps)
    if "h" in chosen:
        kernel_h(data, device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
