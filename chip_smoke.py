#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``sgc_tpu_torch``) on one card.

    python3 chip_smoke.py [--scale 1.0] [--seed 42] [--reps 5]

Drives the port's main path once at full model width (F = 602, 41
classes, 512 x 512 cells, K = 2 hops, 8 Newton steps), the clustered
Reddit-shaped SGC pipeline:

    synthetic_reddit_clustered(scale, shuffle=True)
    -> LocalityPlan.build(formulation="auto")      (LPA order + splits)
    -> khop_traceable(degree=2, precision="f32")   (kernel A + kernel B)
    -> _newton_linear_fit(steps=8), gated against the LBFGS oracle

then runs the same hops under the admission rates measured on the card
(``calibrate=True``), and the reference's other formulation on the same
data, counters zeroed just before it and read just after:

    -> LocalityPlan.build(formulation="onehot")    (hybrid splits)
    -> khop_traceable(degree=2)                    (kernel C + kernel B)
    -> _newton_linear_fit(steps=8), gated against the LBFGS oracle

It then holds each CUDA kernel against its plain PyTorch version on the
paths' own inputs (kernel A at both precisions in both cell orders and
in the grouped layout, kernel B, kernel C through both entries (kernel
B's CUDA kernel on the tiled layout's edges re-sorted by row; "f32" and
"bf16"), kernel D through ``sddmm`` with two different operands on the
main operator (both precisions) and on the same graph in its shuffled
order), checks that kernels A, C and D give identical bits across two
launches, and drives ``spmm(impl=...)`` for every impl.

The main path's plan build, repeated after its timed run, runs under
``stack_sampler(0.05)`` and then bare (the sampler's cost), and one of
its block-dense hops under ``device_trace`` (``prep_attribution``: the
host's top 10 leaves, the top 5 device ops); ``roofline_report`` on
the main split holds its bytes to kernel A's and kernel B's counts in
the kernels line (``roofline``; every bound and count comes from
``sgc_tpu_torch/ops/roofline.py``). Then the ported TPU experiment
probes, every kernel's counter (A-D's and E-H's) zeroed just before
and read just after:

    probe_path:   each ``sgc_tpu_torch/scripts`` module's ``run`` at its
                  script's defaults: exp_pallas_probe and exp_pallas_probe2
                  (kernel E, y = 2 x and the per-CTA block index),
                  exp_take_probe (kernel F's load and async entries,
                  65,536 rows of a 2,048 x 768 table) and
                  exp_dma_gather_probe (async, 64 rows), exp_gather_probe
                  in all five modes (kernel G, 65,536 edges into 2,048 x
                  768), exp_dense_term on the main path's split (kernel A
                  at "bf16", then kernel H on the quantized cells at both
                  feature tiles, in super-row order); then every kernel
                  and entry held against its plain version (E and F
                  exactly, F on its bulk-copy path at every depth and on
                  its 4-byte load and cp.async paths, G and H at 1e-5;
                  the same bits twice), timed beside its bound, plain
                  version, library call and device time; E and F at the
                  DMA shape over 1,000 calls beside the launch floor, F
                  beside the write ceiling; G's
                  bucket and accumulate passes timed apart beside its
                  chain bound (the longest row's dependent adds at the
                  FADD latency measured on the card and its clock), H's
                  shares of its byte bound and of its dense form's
                  compute floor beside its error and tile reads

Then the ported experiments that answer the port's open questions,
kernels A-D's counters zeroed just before each script's run and read just
after:

    script_path:  each ``sgc_tpu_torch/scripts`` module's ``run`` at its
                  reference script's defaults: exp_topology_sweep (12
                  topologies at scale 0.25: segment, calibrated and
                  uncalibrated auto, onehot hops), exp_beyond_device and
                  exp_beyond_stages (an NCCL world of one rank at
                  SGC_BEYOND_SCALE 0.05), exp_newton_head (scale 0.25),
                  exp_lbfgs_cost (152,410 x 602, m = 1, 5, 40),
                  exp_pad_study (scale 1.0, host), exp_crossover (uniform,
                  0.05-0.5), exp_flat_sweep (0.1), exp_hybrid_sweep (1.0,
                  LPA order) and exp_super_rows (the main path's plan, 6
                  cell orders); every kernel A, B and C launch of their
                  hops held against its plain version on the same inputs
                  (A at "f32" and "bf16", C at both precisions, all at
                  1e-5), the ranks holding their own; each script's host
                  results checked; the topology sweep's pass and the
                  crossover's winner printed, not enforced

Then the sharded path
(``sgc_tpu_torch.parallel``) on the main path's plan-order graph, each
rank zeroing its counters just before a run and reading them just
after:

    sharded_path: partition_graph(P = 4), build_halo(overlap=True) and
                  build_sharded_blockdense at the committed admission, and
                  P = 2 and 1 plans, written under build/ for the ranks;
                  4 ranks on cuda:0 over gloo (parallel.distributed.launch:
                  spawn, a file:// store): all-gather, halo, overlapped
                  halo, block-dense at "f32" and "bf16", edge_chunk and
                  col_chunk on mesh (4, 1) and halo on (2, 2), every kernel
                  A and B launch held against its plain version and each
                  form's fetch_global against two kernel-B hops on one
                  device; validate_exchange clean and faulted;
                  assert_deterministic; 8 Adam steps on (2, 2) against
                  (1, 1); measure_spmm_scaling (P ranks on one card, gloo
                  over host: not a scaling figure); an NCCL world of one
                  rank whose block-dense hop and train step equal a gloo
                  mesh's bit for bit; then, the world ended, rank 0's
                  operands alone on the card: each kernel call of a
                  block-dense hop (F = 602) and of its backward (F = 41)
                  beside its library call
    sharded_training_path:
                  on sharded_path's plans and inputs, one 4-rank gloo
                  world on cuda:0: fit_sharded on (2, 2) (the auto
                  formulation, block-dense), Adam epochs checkpointed and
                  resumed bit for bit, the Newton trainer against the
                  single-device Newton fit, the staged form (mmap_rows)
                  bit for bit the ndarray form; fit_gcn_sharded on (4, 1)
                  through the halo plan against the single-device GCN
                  from the same parameters, then steps through the
                  block-dense plan with every kernel A and B launch of
                  one step, forward and backward (the transposed cell
                  plan and remainders), held against its plain version;
                  inductive_dual_propagate on the full and train graphs,
                  segment and block-dense, against single-device kernel-B
                  hops; beside it an NCCL world of one rank whose
                  fit_sharded equals a gloo mesh's bit for bit;
                  InferenceEngine(shard_store=True), f32 and int8, bit for
                  bit the unsharded engine; and the entry points as
                  processes: cli.reddit --sharded --inductive,
                  cli.citation --sharded (SGC and GCN), cli.scaling and
                  cli.dist_demo

Then the single-device remainder,
counters zeroed just before each run and read just after:

    ordering_path:    LocalityPlan.build(ordering=rcm | bfs | degree |
                      none) on the main path's shuffled graph, two hops
                      each (kernels A + B, each launch held against its
                      plain version at f32), rows in the loader's
                      numbering against the LPA plan's and kernel B's
                      hops (bf16; f32 with no cell); spectral on a
                      Cora-shape fixture, its largest eigensolve converged
    graph_store:      eight Pubmed-shape graphs through block_diag, one
                      kernel-B product at F = 500, each block bit-equal
                      to its member's own; save_graph / load_graph of the
                      batch, the same arrays and product bits
    kernel_bench_cli: cli.pallas_bench --scale 1.0 --clustered
                      --blockdense --flat (kernels A, B, C) and --scale
                      0.1 --precision bf16 (kernel C's stripe entry),
                      errors against kernel B, kernels A + B against the
                      plain block-dense version, no *_error key
    devices_cli:      cli.devices on the card names it

Then it drives the user-facing entry points, counters zeroed just before
each run and read just after:

    reddit_cli:   a Reddit-format pair at Reddit's published shape
                  (232,965 nodes, the directed half of 11,606,919 edges,
                  602 features, 41 classes, GraphSAGE's 152,410 / 23,699
                  / 55,334 split; clustered recipe from --seed, written
                  under build/) -> cli.reddit.run(inductive=True,
                  test=True), plain (kernel B) and locality=True
                  (calibrated LocalityPlan), eval features of both held
                  together, micro-F1 above 5x chance on each
    citation_cli: a Planetoid-format set at Pubmed's shape (19,717
                  nodes, 44,338 edges, 500 features, 3 classes; 60 / 500
                  / 1,000) -> cli.citation.run for sgc, appnp and ssgc,
                  cli.sweep.sweep(K = 1, 2, 3), sgc_precompute(degree=2)
                  under every impl against segment with each impl's
                  kernels counted, and out_rows=idx_test bit-equal to the
                  full result's rows

Then the paths that train through the graph, whose backward runs on the
kernels too (kernel B over the transpose, kernel D for the attention
values), each with counters zeroed just before and read just after:

    gat_reddit:   a two-layer GAT (Velickovic et al. 2018, Pubmed widths:
                  8 heads x 8 concatenated, 8 output heads averaged), 3
                  Adam steps on the clustered Reddit graph above, twice
                  (the same bits); the backward's kernel D and transposed
                  kernel B held against their plain versions on the
                  step's own operands and timed beside the forward
                  kernel B, with bounds and library calls
    gcn_cli:      cli.citation.run(model="GCN", tuned=True) on the
                  Pubmed-shape fixture, twice (the same parameter bits),
                  and one GCN gradient held against a CPU copy
    gat_pubmed:   the same GAT, 200 Adam epochs on that fixture, one
                  gradient held against a CPU copy
    deep_gcn:     an 8-layer residual deep GCN (hidden 64): remat on and
                  off give the same bits, Adam steps lower the loss
    tuning_cli:   cli.tuning.tune_citation, 60 TPE fits, then grid=16

Then the TextSGC path at the COVID-19 corpus's shape (9,187 docs, 31
classes, 14,832 words: a 24,019-node doc-word graph of ~10.1M nnz),
counters zeroed just before each run and read just after:

    text_path:    write_text_corpus -> cli.build_graph (window 20) ->
                  load_corpus("BCD") -> text_structural_features at
                  sparse (kernel B), blockdense (kernels A + B) and dense,
                  held against each other; kernel B at the phases' chunk
                  widths (F = 2048, 482, 736, 1,825) and kernel A at 2048
                  on the doc-word split held against their plain versions
                  and timed; cli.textsgc.run with LBFGS and with Newton,
                  each twice (the same bits, test accuracy >= 2x chance);
                  run_crossval (2 folds) and tune_text (4 TPE evals)

Then serving a trained head at Reddit's shape, counters zeroed just
before each run and read just after:

    serve_path:   synthetic_reddit(scale) on the card ->
                  sgc_precompute(degree=2) (kernel B) and
                  propagate_with_checkpoints stopped after its first hop
                  and resumed (the same bits) -> the Newton head through
                  save_params / load_params -> InferenceEngine f32, int8
                  (the store) and inductive (the graph, fanouts 25, 10)
                  -> cli.serve._bench_variant at batches 1 to 1024, 30
                  requests each, blocking and pipelined (depth 2): p50,
                  p99 and rows/s beside the dispatch floor; pipelined
                  equal to blocking bit for bit, f32 logits against a
                  float64 product, int8 within its dequantization bound
                  and agreeing on 99% of the rows, the inductive tree's
                  reduction against float64 and timed with its gathered
                  bytes, and the HTTP endpoint's four routes against the
                  engine

Then the text baselines and the text preparation, on one COVID-19-shape
corpus (write_text_corpus, 7,362 train / 1,825 test docs, 31 classes),
counters zeroed just before each run and read just after:

    sequence_path:  cli.sequence.run at its defaults (the transformer at
                    dim 256, 4 heads, 4 layers, max_len 256, vocab 30,000,
                    batch 32) for 2 epochs: ms a step, tokens/s, predict
                    ms, test accuracy >= 2x chance, a profiled window;
                    two short trainings the same bits; one step against a
                    CPU copy; an empty doc finite (the token-embedding
                    gradient is kernel B)
    word2vec_path:  cli.word2vec.run at its defaults for 1 epoch, twice
                    (the same bits; two kernel-B launches a step), then
                    one epoch at lr 0.0025 (finite); kernel B at
                    F = 100 on one step's updates against its plain
                    version, timed beside index_add_; cli.build_graph
                    --embeddings on the written npz
    embedding_path: a tiny BERT (no download) embeds the vocabulary on the
                    card (grad mode left on) and train.finetune takes 8
                    steps; skipped when transformers is not installed
    text_prep:      write_scopus_csv -> prepare_covid_dataset (7,362 /
                    1,825 abstracts, 34 labels) -> clean_corpus (host)

Last, the benchmark entry point as a process, its counters zeroed just
before each leg and read just after (in its sidecar):

    bench_path:     python -m sgc_tpu_torch.bench at --scale, both
                    topologies: exit 0, a compact line of at most 1200
                    chars, every parity gate passed, dense_frac equal to
                    calibrated_path's (headline), main_path's and
                    onehot_path's (forms), each leg's kernels launched,
                    the roofline terms, the 8-part plan and the sweep

Phases print one JSON line each on stdout; the line before the last is
``{"kernels": [...]}`` (each row also carries its launches on the new
paths, ``launches_by_path``) and the last is ``{"ok": true, "device":
{...}}``. Any failed phase raises, so the script exits non-zero and
prints no result; so does a run without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

# peaks, bounds and byte/operation counts: sgc_tpu_torch/ops/roofline.py
# relative to max|plain|: kernel and plain differ only in f32 sum order
TOLERANCE = 1e-5
# relative to max|main path|: bf16 cells vs f32 edges (2^-8 per value)
BF16_TOLERANCE = 1e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``reps`` calls after one warm call."""
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


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase_device() -> str:
    import torch

    from sgc_tpu_torch.bench import card_line

    card = card_line(torch.device("cuda", 0))
    print(card, flush=True)
    # FP32 matmuls in the plain versions stay full FP32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return card


def phase_build() -> None:
    from sgc_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    seconds = kernels.build_all()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_library_s": seconds})


def phase_calibrate(device) -> dict:
    from sgc_tpu_torch.ops.calibrate import measured_rates
    from sgc_tpu_torch.ops.capability import require_cuda_kernels
    from sgc_tpu_torch.ops.spmm_blockdense import min_edges_for

    t0 = time.perf_counter()
    require_cuda_kernels(device)
    t1 = time.perf_counter()
    rates = measured_rates(device)
    t2 = time.perf_counter()
    min_edges = min_edges_for(512, 512, 602,
                              eff_flops=rates["blockdense_eff_flops"],
                              xla_edges_per_s=rates["xla_edges_per_s"])
    emit({"phase": "calibrate", "capability_s": t1 - t0,
          "calibrate_s": t2 - t1, "rates": rates,
          "min_edges_per_cell": min_edges})
    return rates


def drive_plan(plan, device, counters) -> dict:
    """One user-level run of a plan: ``khop_traceable(degree=2)`` and the
    8-step Newton head, warm, then timed (the bench's pair of regions,
    ``sgc_tpu_torch/bench.py::time_hops_and_head``); the launch counters
    in ``counters`` ({name: registry counter}) are zeroed just before and
    read just after the timed run and the timed hops."""
    import torch

    from sgc_tpu_torch.bench import time_hops_and_head
    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.utils.profiling import read_counts

    x = torch.as_tensor(plan.features, device=device)
    n_classes = int(plan.labels.max()) + 1
    params0 = init_sgc(torch.Generator().manual_seed(42), x.shape[1],
                       n_classes, device=device)
    y = torch.as_tensor(plan.labels[plan.idx_train], device=device).long()
    cw = torch.ones(n_classes, device=device)
    khop, dev_args = plan.khop_traceable(degree=2, precision="f32")
    t = time_hops_and_head(khop, dev_args, x, params0, y, 0.0, cw, device)
    tr = t["tr"]
    launches = read_counts(counters)
    if tuple(tr.shape) != (len(plan.idx_train), x.shape[1]):
        raise AssertionError(f"propagated shape {tuple(tr.shape)}")
    edges = plan.graph.nnz + plan.graph_final.nnz
    return {"x": x, "y": y, "cw": cw, "params0": params0, "tr": tr,
            "dev_args": dev_args, "launches": launches,
            "timings": {"warm_s": t["warm_s"], "total_s": t["total_s"],
                        "hops_s": t["hops_s"], "edges": edges,
                        "edges_per_s": edges / t["hops_s"]}}


def phase_main_path(args, device) -> dict:
    from sgc_tpu_torch.bench import train_parity
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm_blockdense
    from sgc_tpu_torch.utils.profiling import zero_counts

    counters = {"blockdense_cells": "launch.blockdense_cells",
                "csr_spmm": "launch.csr_spmm"}
    zero_counts()
    t0 = time.perf_counter()
    graph, features, labels, idx_train = synthetic_reddit_clustered(
        args.scale, seed=args.seed, shuffle=True)
    emit({"phase": "data", "data_s": time.perf_counter() - t0,
          "nodes": graph.n_rows, "nnz": graph.nnz,
          "features": int(features.shape[1]),
          "classes": int(labels.max()) + 1, "train": len(idx_train)})

    t0 = time.perf_counter()
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="auto", device=device)
    prep_s = time.perf_counter() - t0
    s = plan.split_main
    log(f"plan: {plan.formulation}, dense_frac {plan.dense_fraction:.4f}, "
        f"cells {s.n_cells}, prep {prep_s:.1f}s {plan.prep_seconds}")
    run = drive_plan(plan, device, counters)
    x, tr, launches = run["x"], run["tr"], run["launches"]

    # the propagated rows against the plain formulation on the card
    (a_main, a_final) = run["dev_args"]
    plain_tr = spmm_blockdense.spmm_block_dense(
        plan.split_final,
        spmm_blockdense.spmm_block_dense(plan.split_main, x, a_main,
                                         precision="f32"),
        a_final, precision="f32")
    abs_err, err = rel_err(tr, plain_tr)
    if not err <= TOLERANCE:
        raise AssertionError(f"propagation vs plain: rel err {err:.3e}")
    del plain_tr

    parity = train_parity(tr, run["y"], run["params0"], 0.0, run["cw"])
    emit({"phase": "main_path", "formulation": plan.formulation,
          "precision": "f32",
          "calibrate": False, "min_edges": s.min_edges,
          "dense_frac": plan.dense_fraction,
          "cells_main": s.n_cells, "cells_final": plan.split_final.n_cells,
          "sparse_edges_main": s.sparse_edges,
          "cell_gb": (s.cell_bytes + plan.split_final.cell_bytes) / 1e9,
          "prep_s": prep_s, "prep_stages": plan.prep_seconds,
          **run["timings"], "launches": launches,
          "propagation_max_abs_err": abs_err,
          "propagation_rel_err": err, "train_parity": parity})
    if not parity["parity_ok"]:
        raise AssertionError(f"train parity failed: {parity}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"plan": plan, "x": x, "launches": launches,
            "data": (graph, features, labels, idx_train), "tr": tr,
            "lpa_rows": rows_by_old_id(plan, tr), "prep_s": prep_s}


def phase_onehot_path(data, device) -> dict:
    """The reference's other formulation on the same data:
    ``LocalityPlan.build(formulation="onehot")`` (hybrid splits), two
    hops through kernel C (dense cells) and kernel B (remainder), the
    Newton head; rows held against kernel B alone over the whole
    operators, and the head against the LBFGS oracle (the bench's gate)."""
    from sgc_tpu_torch.bench import train_parity
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm
    from sgc_tpu_torch.utils.profiling import zero_counts

    counters = {"tiled_spmm": "launch.tiled_spmm",
                "csr_spmm": "launch.csr_spmm"}
    zero_counts()
    t0 = time.perf_counter()
    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    prep_s = time.perf_counter() - t0
    run = drive_plan(plan, device, counters)
    x, tr, launches = run["x"], run["tr"], run["launches"]

    # all-segment oracle: kernel B alone over the whole operators
    g_main = plan.graph.to(device)
    g_final = plan.graph_final.to(device)
    oracle = spmm.spmm_segment(g_final, spmm.spmm_segment(g_main, x))
    abs_err, err = rel_err(tr, oracle)
    del oracle
    if not err <= TOLERANCE:
        raise AssertionError(f"onehot rows vs all-segment: {err:.3e}")
    parity = train_parity(tr, run["y"], run["params0"], 0.0, run["cw"])
    s, sf = plan.split_main, plan.split_final
    emit({"phase": "onehot_path", "formulation": plan.formulation,
          "min_fill": s.min_fill, "dense_frac": plan.dense_fraction,
          "dense_edges_main": s.dense_edges,
          "sparse_edges_main": s.sparse_edges,
          "slots_main": int(s.tiled.rows.shape[0]), "pad_main": s.pad,
          "slots_final": int(sf.tiled.rows.shape[0]), "pad_final": sf.pad,
          "prep_s": prep_s, "prep_stages": plan.prep_seconds,
          **run["timings"], "launches": launches,
          "rows_vs_all_segment_max_abs_err": abs_err,
          "rows_vs_all_segment_rel_err": err, "train_parity": parity})
    if not parity["parity_ok"]:
        raise AssertionError(f"onehot train parity failed: {parity}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"plan": plan, "x": x, "launches": launches, "graph": g_main}


def phase_calibrated_path(data, tr_main, device) -> float:
    """The same hops under admission by the rates measured on this card
    (``calibrate=True``): the split the card's own cost model picks, its
    dense fraction and hop time, and its rows against the main path's."""
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.utils.profiling import sync

    t0 = time.perf_counter()
    plan = LocalityPlan.build(*data, formulation="auto", calibrate=True,
                              device=device)
    prep_s = time.perf_counter() - t0
    khop, dev_args = plan.khop_traceable(degree=2, precision="f32")
    x = torch.as_tensor(plan.features, device=device)
    khop(x, dev_args)
    sync(device)
    t0 = time.perf_counter()
    tr = khop(x, dev_args)
    sync(device)
    hops_s = time.perf_counter() - t0
    # the main path stores its cells' values in bf16, this split keeps
    # (almost) every edge in f32: they agree to bf16 rounding of the
    # operator, not to f32
    _, err = rel_err(tr, tr_main)
    if not err <= BF16_TOLERANCE:
        raise AssertionError(f"calibrated vs main path rows: {err:.3e}")
    edges = plan.graph.nnz + plan.graph_final.nnz
    emit({"phase": "calibrated_path", "precision": "f32",
          "min_edges": plan.split_main.min_edges,
          "dense_frac": plan.dense_fraction,
          "cells_main": plan.split_main.n_cells,
          "cells_final": plan.split_final.n_cells, "prep_s": prep_s,
          "hops_s": hops_s, "edges_per_s": edges / hops_s,
          "rows_vs_main_path_rel_err": err})
    return plan.dense_fraction


def cells_csr(split, dargs, n_slots):
    """The nonzero entries of the first ``n_slots`` cell slots (their bf16
    values, widened) as one CSR matrix on the card: kernel A's function at
    precision "f32" as a sparse matrix (yardstick only). Zero slots (the
    grouped layout's holes) add no entry."""
    import torch

    R, W = split.row_block, split.stripe
    cells = dargs.cells[:n_slots]
    k, r, w = cells.nonzero(as_tuple=True)
    rb = torch.as_tensor(split.rb_ids[:n_slots], device=cells.device)
    st = torch.as_tensor(split.st_ids[:n_slots], device=cells.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        return torch.sparse_coo_tensor(
            torch.stack([rb[k].long() * R + r, st[k].long() * W + w]),
            cells[k, r, w].float(),
            (split.n_rows, split.n_cols)).coalesce().to_sparse_csr()


def phase_kernel_a(plan, x, launches, reps) -> dict:
    """Kernel A in both cell orders at both precisions on the main split,
    and at both precisions on the last-hop split: two launches equal bit
    for bit, "f32" held against the plain f32 product and "bf16" against
    the plain product on bf16-rounded x, both at 1e-5."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_blockdense as bd

    R, W = plan.split_main.row_block, plan.split_main.stripe
    F = int(x.shape[1])
    split_super = plan.split_main
    args_super = plan._device_args()[0]
    split_classic = bd.split_block_dense(
        plan.graph, F, R, W, min_edges=split_super.min_edges,
        super_rows=None)
    if split_classic.n_cells != split_super.n_cells:
        raise AssertionError("the two cell orders admitted different cells")
    args_classic = bd.blockdense_device_args(split_classic, x.device)
    orders = {}
    for name, split, dargs in (("super_rows_8", split_super, args_super),
                               ("classic", split_classic, args_classic)):
        for precision in bd.PRECISIONS:
            got = bd.apply_cells(split, dargs, x, precision)
            again = bd.apply_cells(split, dargs, x, precision)
            want = bd.apply_cells_plain(split, dargs, x, precision)
            abs_err, err = rel_err(got, want)
            if not err <= TOLERANCE:
                raise AssertionError(
                    f"kernel A ({name}, {precision}) vs plain: {err:.3e}")
            if not torch.equal(got, again):
                raise AssertionError(f"kernel A ({name}, {precision}): two "
                                     "launches differ")
            del got, again, want
            orders[f"{name}/{precision}"] = {
                "max_abs_err": abs_err, "rel_err": err,
                "ms": time_ms(
                    lambda: bd.apply_cells(split, dargs, x, precision), reps),
                "plain_ms": time_ms(
                    lambda: bd.apply_cells_plain(split, dargs, x, precision),
                    2)}
    del args_classic
    # the last hop's split (train rows only), for the hop-time breakdown
    args_final = plan._device_args()[1]
    final_ms = {p: time_ms(
        lambda: bd.apply_cells(plan.split_final, args_final, x, p), reps)
        for p in bd.PRECISIONS}

    n_real = split_super.n_cells
    # yardstick 1 (not the same function): one gathered f32 bmm of every
    # cell against its stripe, the per-cell products without the sum
    xp = x.new_zeros((split_super.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split_super.st_ids[:n_real], device=x.device).long()
    cells_f32 = args_super.cells[:n_real].float()
    xg = xp.view(-1, W, F)[st]
    bmm_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp
    # yardstick 2 (the same function as precision "f32"): the cells'
    # nonzero entries as one CSR matrix, torch.addmm
    csr = cells_csr(split_super, args_super, n_real)
    zero = x.new_zeros((split_super.n_rows, F))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    csr_nnz = int(csr._nnz())
    del csr, zero

    main = "super_rows_8/f32"
    passes = bd.n_passes("f32")
    bound = rf.kernel_a_bound(split_super, args_super, n_real, F, passes)
    if bound["cell_nonzeros"] != csr_nnz:
        raise AssertionError("kernel A's bound and its CSR yardstick count "
                             "different nonzeros")
    bf16_ms = orders["super_rows_8/bf16"]["ms"]
    row = {"name": "blockdense_cells", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/blockdense.cu",
           "replaces": ("sgc_tpu/ops/spmm_blockdense.py:353, :330, :381"),
           "precision": "f32", "passes": passes,
           "launches": launches["blockdense_cells"],
           "max_abs_err": max(o["max_abs_err"] for o in orders.values()),
           "ms": orders[main]["ms"], "plain_ms": orders[main]["plain_ms"],
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "library_ms": library_ms, "ops": bound["ops"],
           "bytes": bound["bytes"]}
    emit({"phase": "kernel_a", "cells": n_real, "F": F, "orders": orders,
          "final_split_cells": plan.split_final.n_cells,
          "final_split_ms": final_ms, "bf16_ms": bf16_ms,
          "launches_note": "calls of kernel A's entry; each is two CUDA "
                           "launches (x_terms_kernel, then the MMA kernel)",
          "library": "torch.addmm, the cells' nonzeros as one CSR matrix "
                     f"({csr_nnz} entries): the same function as 'f32'",
          "bmm_f32_yardstick_ms": bmm_ms, "tolerance_rel": TOLERANCE,
          **bound,
          "dense_form_achieved_tflops":
              bound["dense_form_ops"] / orders[main]["ms"] / 1e9,
          "bf16_dense_form_achieved_tflops":
              bound["dense_form_ops"] / passes / bf16_ms / 1e9, **row})
    return row


def b_width(name, graph, x, dense, reps) -> dict:
    """Kernel B on one operand: held against the plain version at
    ``TOLERANCE`` and to the same bits over two launches, then timed
    beside its bound (``b_bound``), the same-function library call, its
    gathered bytes per second, and the operand's largest row alone (the
    chain the kernel's tail waits for)."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops.spmm import (
        csr_plan,
        launch_csr,
        operand_align,
        spmm_segment,
        spmm_segment_plain,
    )

    F = int(x.shape[1])
    got = spmm_segment(graph, x, dense)
    again = spmm_segment(graph, x, dense)
    abs_err, err = rel_err(got, spmm_segment_plain(graph, x, dense))
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel B ({name}) vs plain: {err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"kernel B ({name}): two launches differ")
    plan = csr_plan(F, False, operand_align(x, dense, got))
    del again
    ms = time_ms(lambda: spmm_segment(graph, x, dense), reps)
    csr = csr_of(graph)
    library_ms = time_ms((lambda: torch.sparse.mm(csr, x)) if dense is None
                         else (lambda: torch.addmm(dense, csr, x)), reps)
    del csr
    deg = graph.row_ptr[1:] - graph.row_ptr[:-1]
    hub = int(deg.argmax())
    h0, h1 = int(graph.row_ptr[hub]), int(graph.row_ptr[hub + 1])
    hub_ptr = torch.tensor([0, h1 - h0], dtype=torch.int32, device=x.device)
    hub_out = torch.empty((1, F), device=x.device)
    hub_dense = None if dense is None else dense[hub:hub + 1]
    hub_ms = time_ms(lambda: launch_csr(
        hub_ptr, graph.cols[h0:h1], graph.vals[h0:h1], x, hub_dense,
        hub_out, plan=plan), reps)
    b_ms, b_by = rf.b_bound(graph, F, dense is not None)
    return {"operand": name, "F": F, "nnz": graph.nnz,
            "plan": dataclasses.asdict(plan), "max_abs_err": abs_err,
            "rel_err": err, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "gathered_gbps": graph.nnz * F * 4 / ms / 1e6,
            "max_degree": h1 - h0, "mean_degree": graph.nnz / graph.n_rows,
            "max_degree_batches": -(-(h1 - h0) // plan.unroll),
            "max_degree_row_alone_ms": hub_ms}


def phase_kernel_b(plan, x, launches, reps, shuffled) -> dict:
    """Kernel B at the widths its callers use, on the Reddit-shape
    operands: F = 602 on the block-dense main split's remainder (with its
    dense term, the main path's launch) and over the whole graph in its
    shuffled order (a plain hop of ``cli.reddit``), and F = 1, 8 and 41
    on that graph (GAT's segment sums, hidden heads and output heads; x
    a column of ones at F = 1, as ``ops.autograd.row_sums``)."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    split = plan.split_main
    dargs = plan._device_args()[0]
    rest = dargs.rest
    dense = bd.apply_cells(split, dargs, x, "f32")
    widths = {"602": b_width("main-split remainder", rest, x, dense, reps)}
    plain_ms = time_ms(lambda: spmm_segment_plain(rest, x, dense), 2)
    args_final = plan._device_args()[1]
    dense_final = bd.apply_cells(plan.split_final, args_final, x, "f32")
    final_ms = time_ms(
        lambda: spmm_segment(args_final.rest, x, dense_final), reps)
    del dense, dense_final
    g = shuffled[0].to(x.device)
    xs = torch.as_tensor(shuffled[1], device=x.device)
    widths["602_shuffled_hop"] = b_width("shuffled graph, a plain hop", g,
                                         xs, None, reps)
    gen = torch.Generator(device=x.device).manual_seed(7)
    for F in (1, 8, 41):
        xf = (torch.ones((g.n_cols, 1), device=x.device) if F == 1 else
              torch.randn((g.n_cols, F), device=x.device, generator=gen))
        widths[str(F)] = b_width("shuffled graph (GAT's)", g, xf, None, reps)
    del g, xs, xf

    main = widths["602"]
    F = int(x.shape[1])
    ops, nbytes = rf.kernel_b_count(split.rest, F, dense=True)
    b_ms, b_by = rf.bound_ms(ops, nbytes)
    row = {"name": "csr_spmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/spmm_csr.cu",
           "replaces": "sgc_tpu/ops/spmm.py:45",
           "launches": launches["csr_spmm"],
           "max_abs_err": max(w["max_abs_err"] for w in widths.values()),
           "ms": main["ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": main["library_ms"],
           "ops": ops, "bytes": nbytes,
           "widths": {k: {m: w[m] for m in ("ms", "bound_ms", "library_ms",
                                            "rel_err", "max_degree")}
                      for k, w in widths.items()}}
    emit({"phase": "kernel_b", "nnz": rest.nnz, "F": F,
          "rel_err": max(w["rel_err"] for w in widths.values()),
          "final_split_nnz": args_final.rest.nnz,
          "final_split_ms": final_ms, "tolerance_rel": TOLERANCE,
          "ops": ops, "bytes": nbytes,
          "achieved_gbps": nbytes / main["ms"] / 1e6, **row,
          "widths": widths})
    return row


def phase_kernel_a_grouped(plan, x, reps) -> None:
    """Kernel A over the grouped layout (``group_cells=4``) of the last-hop
    operator: an index whose (panel, stripe) runs are padded with zero
    hole cells."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_blockdense as bd

    R, W, F = 512, 512, int(x.shape[1])
    split = bd.split_block_dense(
        plan.graph_final, F, R, W, min_edges=plan.split_final.min_edges,
        super_rows=8, group_cells=4)
    dargs = bd.blockdense_device_args(split, x.device)
    got = bd.apply_cells(split, dargs, x, "f32")
    want = bd.apply_cells_plain(split, dargs, x, "f32")
    abs_err, err = rel_err(got, want)
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel A (grouped) vs plain: {err:.3e}")
    del got, want
    ms = time_ms(lambda: bd.apply_cells(split, dargs, x, "f32"), reps)
    plain_ms = time_ms(
        lambda: bd.apply_cells_plain(split, dargs, x, "f32"), 1)
    # yardstick 1 (not the same function): the real cells' products as
    # one gathered f32 bmm
    real = np.flatnonzero(dargs.cells[: split.n_slots].flatten(1).any(1)
                          .cpu().numpy())
    xp = x.new_zeros((split.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split.st_ids[real], device=x.device).long()
    cells_f32 = dargs.cells[torch.as_tensor(real, device=x.device)].float()
    xg = xp.view(-1, W, F)[st]
    bmm_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp
    # yardstick 2 (the same function as precision "f32"): the cells'
    # nonzero entries as one CSR matrix, torch.addmm
    csr = cells_csr(split, dargs, split.n_slots)
    zero = x.new_zeros((split.n_rows, F))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    csr_nnz = int(csr._nnz())
    del csr, zero
    bound = rf.kernel_a_bound(split, dargs, split.n_cells, F,
                           bd.n_passes("f32"))
    if bound["cell_nonzeros"] != csr_nnz:
        raise AssertionError("the grouped bound and its CSR yardstick count "
                             "different nonzeros")
    del dargs
    emit({"phase": "kernel_a_grouped", "group_cells": 4, "super_rows": 8,
          "precision": "f32", "passes": bd.n_passes("f32"),
          "cells": split.n_cells, "slots": split.n_slots,
          "nonzero_slots": len(real), "F": F, "max_abs_err": abs_err,
          "rel_err": err, "tolerance_rel": TOLERANCE, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "torch.addmm, the cells' nonzeros as one CSR matrix "
                     f"({csr_nnz} entries): the same function as 'f32'",
          "bmm_f32_yardstick_ms": bmm_ms, **bound})


def csr_of(graph):
    """A torch CSR matrix of a graph on the card (yardsticks only)."""
    import torch

    nnz = graph.nnz
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        return torch.sparse_csr_tensor(
            graph.row_ptr, graph.cols[:nnz], graph.vals[:nnz],
            size=(graph.n_rows, graph.n_cols), check_invariants=False)


def phase_kernel_c(onehot, reps) -> dict:
    """Kernel C (the CSR kernel on the layout's edges re-sorted by row)
    through both entries (flat and stripe walk) on the onehot main split,
    against the plain version."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_tiled as ti
    from sgc_tpu_torch.ops.spmm import spmm_segment

    plan, x = onehot["plan"], onehot["x"]
    split = plan.split_main
    tiled = split.tiled
    args_flat = plan._device_args()[0].tiled
    flat, walk = ti.flat_index(tiled), ti.stripe_index(tiled)
    if not all(np.array_equal(a, b) for a, b in zip(flat, walk)):
        raise AssertionError("the two chunk schedules disagree")
    # the plan's row index is the native one (built in prep); the stripe
    # entry runs on the numpy twin's, which must be the same arrays
    t0 = time.perf_counter()
    plain_index = ti.row_index_plain(tiled)
    plain_index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_index = ti.row_index(tiled)
    native_index_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(native_index,
                                                     plain_index)):
        raise AssertionError("kernel C's native and plain row index differ")
    args_walk = ti.tiled_device_args(tiled, x.device,
                                     ti.row_csr(tiled, plain_index))
    entries = {}
    for name, fn, dargs in (("flat", ti.spmm_tiled_flat, args_flat),
                            ("stripes", ti.spmm_tiled_stripes, args_walk)):
        got = fn(tiled, x, dargs)
        again = fn(tiled, x, dargs)
        want = ti.spmm_tiled_plain(tiled, x)
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"kernel C ({name}) vs plain: {err:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"kernel C ({name}): two launches differ")
        del got, again, want
        entries[name] = {
            "max_abs_err": abs_err, "rel_err": err,
            "ms": time_ms(lambda: fn(tiled, x, dargs), reps),
            "plain_ms": time_ms(
                lambda: ti.spmm_tiled_plain(tiled, x), 2)}
    del args_walk
    # the reference's precision="bf16" through the flat entry
    got = ti.spmm_tiled_flat(tiled, x, args_flat, "bf16")
    again = ti.spmm_tiled_flat(tiled, x, args_flat, "bf16")
    want = ti.spmm_tiled_plain(tiled, x, "bf16")
    bf16_abs_err, bf16_err = rel_err(got, want)
    if not bf16_err <= TOLERANCE:
        raise AssertionError(f"kernel C (flat, bf16) vs plain: "
                             f"{bf16_err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError("kernel C (flat, bf16): two launches differ")
    del got, again, want
    entries["flat_bf16"] = {
        "max_abs_err": bf16_abs_err, "rel_err": bf16_err,
        "ms": time_ms(lambda: ti.spmm_tiled_flat(tiled, x, args_flat,
                                                 "bf16"), reps),
        "plain_ms": time_ms(lambda: ti.spmm_tiled_plain(tiled, x, "bf16"),
                            2)}
    final = plan.split_final
    args_final = plan._device_args()[1].tiled
    final_ms = time_ms(
        lambda: ti.spmm_tiled_flat(final.tiled, x, args_final), reps)
    # the hop's other half: kernel B on each remainder, adding the dense
    # part in its epilogue
    rest_ms = {}
    for name, s, hargs in (("main", split, plan._device_args()[0]),
                           ("final", final, plan._device_args()[1])):
        if hargs.rest is not None:
            dense = ti.spmm_tiled_flat(s.tiled, x, hargs.tiled)
            rest_ms[name] = time_ms(
                lambda: spmm_segment(hargs.rest, x, dense), reps)
            del dense

    # yardstick: the dense part's slots as one coalesced CSR matrix
    # (duplicates and padding summed: the same operator), torch.addmm
    rows, cols, vals = (torch.as_tensor(a, device=x.device)
                        for a in (tiled.rows, tiled.cols, tiled.vals))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]).long(), vals,
        (tiled.n_rows, tiled.n_cols)).coalesce()
    del rows, cols, vals
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        csr = csr.to_sparse_csr()
    zero = x.new_zeros((tiled.n_rows, x.shape[1]))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    del csr, zero

    F = int(x.shape[1])
    slots = int(tiled.rows.shape[0])
    edges = int(args_flat.cols.shape[0])
    ops, nbytes = rf.kernel_c_count(tiled, split.dense_edges, edges, F)
    b_ms, b_by = rf.bound_ms(ops, nbytes)
    row = {"name": "tiled_spmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/spmm_csr.cu",
           "replaces": "sgc_tpu/ops/spmm_pallas.py:169, :393",
           "precision": "f32",
           "launches": onehot["launches"]["tiled_spmm"],
           "max_abs_err": max(e["max_abs_err"] for e in entries.values()),
           "ms": entries["flat"]["ms"],
           "plain_ms": entries["flat"]["plain_ms"], "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "bf16_ms": entries["flat_bf16"]["ms"],
           "bf16_max_abs_err": entries["flat_bf16"]["max_abs_err"],
           "ops": ops, "bytes": nbytes}
    emit({"phase": "kernel_c", "kernel": "csr_spmm on the re-sorted layout",
          "slots": slots, "index_edges": edges,
          "row_index_native_s": native_index_s,
          "row_index_plain_s": plain_index_s,
          "dense_edges": split.dense_edges, "pad": split.pad, "F": F,
          "entries": entries, "final_split_slots":
          int(final.tiled.rows.shape[0]), "final_split_ms": final_ms,
          "remainder_nnz": {"main": split.sparse_edges,
                            "final": final.sparse_edges},
          "remainder_kernel_b_ms": rest_ms,
          "tolerance_rel": TOLERANCE, "ops": ops, "bytes": nbytes,
          "achieved_gbps": nbytes / entries["flat"]["ms"] / 1e6, **row})
    return row


def sddmm_on(g, a, b, reps, precisions) -> dict:
    """Kernel D through ``sddmm`` on one graph: its warps' segments, the
    runs of one row within them (one read of a's row each) and the bytes
    the kernel gathers, and per precision one counted call (counter zeroed
    just before, read just after), two launches equal bit for bit,
    padding 0, the error against the plain version, and the times of
    kernel, plain and library. The library call is
    ``torch.sparse.sampled_addmm`` in f32, at "bf16" on f32 copies of a
    and b rounded to bf16 (made outside the timed call): a product of two
    bf16 values is exact in f32, so it computes the same function."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm
    from sgc_tpu_torch.utils.profiling import read_counts, zero_counts

    F, nnz = int(a.shape[1]), g.nnz
    # edges per warp of kernel D's f32 plan, to count its row runs
    seg = spmm.sddmm_plan(F, "f32", spmm.operand_align(a, b)).seg
    rows = g.rows[:nnz]
    starts = torch.ones(nnz, dtype=torch.bool, device=a.device)
    starts[1:] = rows[1:] != rows[:-1]
    starts[::seg] = True
    runs = int(starts.sum())
    out = {"nnz": nnz, "e_pad": g.n_edges_padded, "F": F,
           "edges_per_warp": seg, "segments": -(-nnz // seg),
           "row_runs": runs}
    csr = csr_of(g)
    for precision in precisions:
        zero_counts()
        got = spmm.sddmm(g, a, b, precision)
        torch.cuda.synchronize()
        launches = read_counts(["launch.sddmm"])["launch.sddmm"]
        if launches != 1:
            raise AssertionError(f"sddmm launched kernel D {launches} "
                                 "times")
        again = spmm.sddmm(g, a, b, precision)
        want = spmm.sddmm_plain(g, a, b, precision)
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"kernel D ({precision}) vs plain: "
                                 f"{err:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"kernel D ({precision}): two launches "
                                 "differ")
        if bool(got[nnz:].any()):
            raise AssertionError("kernel D wrote a padding slot")
        del got, again, want
        itemsize = 2 if precision == "bf16" else 4
        b_ms, b_by, ops, nbytes = rf.sddmm_bound(g, F, itemsize)
        if precision == "bf16":
            ac, bct = spmm.bf16_round(a), spmm.bf16_round(b).t()
        else:
            ac, bct = a, b.t()
        library_ms = time_ms(
            lambda: torch.sparse.sampled_addmm(csr, ac, bct, beta=0.0), reps)
        del ac, bct
        ms = time_ms(lambda: spmm.sddmm(g, a, b, precision), reps)
        out[precision] = {
            "launches": launches, "max_abs_err": abs_err, "rel_err": err,
            "ms": ms,
            "plain_ms": time_ms(
                lambda: spmm.sddmm_plain(g, a, b, precision), 1),
            "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "gathered_b_bytes": nnz * F * itemsize,
            "a_row_bytes": runs * F * 4,
            "achieved_gbps": nbytes / ms / 1e6}
    return out


def phase_kernel_d(onehot, shuffled, reps) -> dict:
    """``sddmm`` over the whole main operator in the LPA order at both
    precisions and over the same graph in its shuffled order at "f32",
    each with two different operands (a = the features, b = one hop of
    them, so a kernel that swapped rows and cols would disagree)."""
    import torch

    from sgc_tpu_torch.ops import spmm

    g, a = onehot["graph"], onehot["x"]
    b = spmm.spmm_segment(g, a)
    lpa = sddmm_on(g, a, b, reps, ("f32", "bf16"))
    del b
    gs = shuffled[0].to(a.device)
    xs = torch.as_tensor(shuffled[1], device=a.device)
    shuffled_order = sddmm_on(gs, xs, spmm.spmm_segment(gs, xs), reps,
                              ("f32",))
    del gs, xs
    f32, bf16 = lpa["f32"], lpa["bf16"]
    row = {"name": "sddmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/sddmm.cu",
           "replaces": "sgc_tpu/ops/spmm_pallas.py:705",
           "precision": "f32", "launches": f32["launches"],
           "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
           "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
           "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
           "bf16_launches": bf16["launches"],
           "bf16_max_abs_err": bf16["max_abs_err"], "bf16_ms": bf16["ms"],
           "bf16_plain_ms": bf16["plain_ms"],
           "bf16_bound_ms": bf16["bound_ms"],
           "bf16_bound_by": bf16["bound_by"],
           "bf16_library_ms": bf16["library_ms"],
           "shuffled_order_ms": shuffled_order["f32"]["ms"]}
    emit({"phase": "kernel_d", "operands": "a = x, b = spmm_segment(graph, "
          "x)", "launches_note": "calls of sddmm; each is one CUDA launch "
          "after a memset of the padding", "tolerance_rel": TOLERANCE,
          "lpa_order": lpa, "shuffled_order": shuffled_order, **row})
    return row


def phase_dispatcher(onehot, reps) -> None:
    """``spmm(graph, x, impl=...)`` for every impl, each against kernel
    B's product; every impl must launch the kernels it stands for."""
    from sgc_tpu_torch.ops import spmm
    from sgc_tpu_torch.utils.buildcache import clear_placed
    from sgc_tpu_torch.utils.profiling import read_counts, zero_counts

    g, x = onehot["graph"], onehot["x"]
    expect = {"auto": ("csr_spmm",), "segment": ("csr_spmm",),
              "chunked": ("csr_spmm",), "tiled": ("tiled_spmm",),
              "hybrid": ("tiled_spmm", "csr_spmm"),
              "blockdense": ("blockdense_cells", "csr_spmm")}
    mods = {"csr_spmm": "launch.csr_spmm", "tiled_spmm": "launch.tiled_spmm",
            "blockdense_cells": "launch.blockdense_cells"}
    ref = spmm.spmm_segment(g, x)
    impls = {}
    for impl in spmm.IMPLS:
        zero_counts()
        t0 = time.perf_counter()
        out = spmm.spmm(g, x, impl=impl)
        first_s = time.perf_counter() - t0
        launches = read_counts(mods)
        _, err = rel_err(out, ref)
        del out
        tol = BF16_TOLERANCE if impl == "blockdense" else TOLERANCE
        if not err <= tol:
            raise AssertionError(f"spmm(impl={impl!r}) vs kernel B: "
                                 f"{err:.3e} > {tol}")
        if any(launches[k] <= 0 for k in expect[impl]):
            raise AssertionError(f"spmm(impl={impl!r}) launched {launches}")
        impls[impl] = {"rel_err": err, "tolerance_rel": tol,
                       "first_call_s": first_s, "launches": launches,
                       "ms": time_ms(lambda: spmm.spmm(g, x, impl=impl),
                                     reps)}
    clear_placed()
    emit({"phase": "dispatcher", "impls": impls})


def counted(fn):
    """``(fn(), launches)``: every kernel's counter, by its row name in the
    kernels line (``sgc_tpu_torch/bench.py::LAUNCH_COUNTERS``), zeroed
    just before the call and read just after it (the card synchronized)."""
    import torch

    from sgc_tpu_torch.bench import LAUNCH_COUNTERS
    from sgc_tpu_torch.utils.profiling import read_counts, zero_counts

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(LAUNCH_COUNTERS)


def scratch_dir():
    """A temporary directory under the checkout's git-ignored build/."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build)


def phase_reddit_cli(args, device) -> dict:
    """The Reddit CLI's ``run(inductive=True, test=True)`` on a
    Reddit-format pair at Reddit's published shape (clustered recipe,
    GraphSAGE's split sizes), once on the plain path (``sgc_precompute``
    on both adjacencies: kernel B) and once with ``locality=True``
    (``LocalityPlan`` with the card's calibrated admission). The eval
    features of both paths must agree (1e-5 relative to max when no cell
    is admitted, the bf16 tolerance otherwise) and micro-F1 must beat 5x
    chance on each."""
    from sgc_tpu_torch.cli import reddit
    from sgc_tpu_torch.data.fixtures import write_reddit

    runs, launches = {}, {}
    with scratch_dir() as root:
        t0 = time.perf_counter()
        counts = write_reddit(root, scale=args.scale, seed=args.seed)
        write_s = time.perf_counter() - t0
        for name, locality in (("plain", False), ("locality", True)):
            t0 = time.perf_counter()
            runs[name], launches[name] = counted(lambda: reddit.run(
                data_path=root, inductive=True, test=True,
                locality=locality, seed=args.seed, device=device))
            runs[name]["wall_s"] = time.perf_counter() - t0
    plain, loc = runs["plain"], runs["locality"]
    dense = max(loc["dense_frac"], loc["train_dense_frac"])
    tol = TOLERANCE if dense == 0 else BF16_TOLERANCE
    abs_err, err = rel_err(loc["eval_features"], plain["eval_features"])
    shape = tuple(plain["eval_features"].shape)
    for r in runs.values():
        del r["eval_features"]
    chance = 1.0 / counts["classes"]
    emit({"phase": "reddit_cli", "fixture": counts, "write_s": write_s,
          "eval_shape": shape, "runs": runs, "launches": launches,
          "locality_vs_plain_max_abs_err": abs_err,
          "locality_vs_plain_rel_err": err, "tolerance_rel": tol,
          "chance": chance})
    if shape != (counts["nodes"], counts["features"]):
        raise AssertionError(f"eval features of shape {shape}")
    if not err <= tol:
        raise AssertionError(f"locality vs plain eval features: {err:.3e}")
    for name, r in runs.items():
        if not r["f1_micro"] > 5 * chance:
            raise AssertionError(f"{name}: micro-F1 {r['f1_micro']:.4f}")
    if launches["plain"]["csr_spmm"] <= 0 or (
            launches["locality"]["csr_spmm"] <= 0 and dense < 1):
        raise AssertionError(f"kernel B never launched: {launches}")
    if dense > 0 and launches["locality"]["blockdense_cells"] <= 0:
        raise AssertionError(f"cells admitted, kernel A idle: {launches}")
    return launches


def phase_citation_cli(args, device) -> dict:
    """The citation CLI at Pubmed's published shape on a Planetoid-format
    fixture: ``run()`` under each propagator and the K sweep, then
    ``sgc_precompute(degree=2)`` under every impl against ``segment``
    (1e-5; ``blockdense`` at its default bf16 x: the bf16 tolerance),
    each impl's kernels shown launched, and ``out_rows=idx_test`` equal
    bit for bit to the full result's rows."""
    import torch

    from sgc_tpu_torch.cli import citation, sweep
    from sgc_tpu_torch.data.fixtures import PUBMED, write_planetoid
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.ops.propagate import sgc_precompute
    from sgc_tpu_torch.ops.spmm import IMPLS
    from sgc_tpu_torch.utils.config import CitationConfig

    runs, launches = {}, {}
    with scratch_dir() as root:
        write_planetoid(root, "pubmed", **PUBMED, seed=args.seed)
        for prop in ("sgc", "appnp", "ssgc"):
            runs[prop], launches[prop] = counted(lambda: citation.run(
                CitationConfig(dataset="pubmed", seed=args.seed), root,
                propagator=prop, device=device))
        rows, launches["sweep"] = counted(lambda: sweep.sweep(
            ["pubmed"], [1, 2, 3], seed=args.seed, data_path=root,
            device=device))
        data = load_citation("pubmed", data_path=root, device=device)
    chance = 1.0 / data.n_classes
    x, g = data.features, data.graph
    seg, _ = sgc_precompute(x, g, 2, impl="segment")
    expect = {"auto": ("csr_spmm",), "segment": ("csr_spmm",),
              "chunked": ("csr_spmm",), "tiled": ("tiled_spmm",),
              "hybrid": ("tiled_spmm", "csr_spmm"),
              "blockdense": ("blockdense_cells", "csr_spmm")}
    impls = {}
    for impl in IMPLS:
        (got, seconds), n = counted(lambda: sgc_precompute(x, g, 2, impl))
        _, err = rel_err(got, seg)
        tol = BF16_TOLERANCE if impl == "blockdense" else TOLERANCE
        (_, warm_s), _ = counted(lambda: sgc_precompute(x, g, 2, impl))
        impls[impl] = {"rel_err": err, "tolerance_rel": tol,
                       "first_s": seconds, "warm_s": warm_s, "launches": n}
        if not err <= tol:
            raise AssertionError(f"sgc_precompute({impl!r}) vs segment: "
                                 f"{err:.3e} > {tol}")
        if any(n[k] <= 0 for k in expect[impl]):
            raise AssertionError(f"sgc_precompute({impl!r}) launched {n}")
    sub, _ = sgc_precompute(x, g, 2, out_rows=data.idx_test)
    bits = bool(torch.equal(
        sub, seg[torch.as_tensor(data.idx_test, device=x.device)]))
    emit({"phase": "citation_cli", "fixture": {
              **PUBMED, "nnz_normalized": g.nnz}, "runs": runs,
          "sweep": rows, "launches": launches, "sgc_precompute": impls,
          "out_rows_bit_equal": bits, "chance": chance})
    if not bits:
        raise AssertionError("out_rows rows differ from the full result's")
    for name, r in runs.items():
        if not r["test_accuracy"] > 2 * chance:
            raise AssertionError(f"{name}: test accuracy "
                                 f"{r['test_accuracy']:.4f}")
    if any(r["test_acc"] <= 2 * chance for r in rows):
        raise AssertionError(f"sweep accuracies: {rows}")
    if any(n["csr_spmm"] <= 0 for n in launches.values()):
        raise AssertionError(f"kernel B never launched: {launches}")
    return launches


# --------------------------------------------- training through the graph


def param_grads(loss_fn, params):
    """``[loss, grad of each parameter]`` of one backward."""
    for p in params:
        p.grad = None
    loss = loss_fn()
    loss.backward()
    return [loss.detach()] + [p.grad.clone() for p in params]


def max_rel_err(got, want) -> float:
    """The largest of ``rel_err`` over paired lists of tensors."""
    return max(rel_err(g.cpu(), w.cpu())[1] for g, w in zip(got, want))


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_gcn_cli(root, device) -> dict:
    """``cli.citation.run(model="GCN", tuned=True)`` on the Pubmed-shape
    fixture, twice: kernel B in both directions (forward, and over the
    transpose in the backward), test accuracy above 2x chance, and the
    two runs' final parameters the same bits. Then one gradient of the
    GCN loss on the card held against a CPU copy (plain kernels) at
    1e-4, with one dropout mask given to both."""
    import torch

    from sgc_tpu_torch.cli import citation
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.models.gcn import gcn_apply, init_gcn
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target
    from sgc_tpu_torch.utils.config import CitationConfig

    fitted = []
    real = citation.train_gcn

    def keep(*a, **kw):
        out = real(*a, **kw)
        fitted.append(out[0])
        return out

    citation.train_gcn = keep
    try:
        runs = [counted(lambda: citation.run(
            CitationConfig(dataset="pubmed", model="GCN", tuned=True), root,
            device=device)) for _ in range(2)]
    finally:
        citation.train_gcn = real
    cfg = CitationConfig(dataset="pubmed", model="GCN", tuned=True).resolve()
    res, launches = runs[0]
    bits = same_bits(list(fitted[0].parameters()),
                     list(fitted[1].parameters()))

    grads = []
    for dev in (device, torch.device("cpu")):
        data = load_citation("pubmed", data_path=root, device=dev)
        m = init_gcn(torch.Generator().manual_seed(7),
                     data.features.shape[1], cfg.hidden, data.n_classes,
                     device=dev)
        mask = (torch.rand((data.graph.n_rows, cfg.hidden),
                           generator=torch.Generator().manual_seed(8))
                < 1.0 - cfg.dropout).to(dev)
        target = train_target(data.graph.n_rows, data.idx_train,
                              data.labels[data.idx_train])
        grads.append(param_grads(lambda: node_cross_entropy(
            gcn_apply(m, data.features, data.graph, dropout_rate=cfg.dropout,
                      keep_mask=mask), *target), list(m.parameters())))
    grad_err = max_rel_err(*grads)
    chance = 1.0 / data.n_classes
    forward_b = launches["csr_spmm"] - launches["csr_spmm_transposed"]
    emit({"phase": "gcn_cli", "config": {k: getattr(cfg, k) for k in (
              "hidden", "dropout", "epochs", "lr", "weight_decay")},
          "runs": [r for r, _ in runs], "launches": launches,
          "s_per_epoch": res["train_time"] / cfg.epochs,
          "params_bit_equal": bits, "grad_vs_cpu_rel_err": grad_err,
          "grad_tolerance_rel": 1e-4, "chance": chance})
    if not bits:
        raise AssertionError("two GCN trainings gave different parameters")
    if not grad_err <= 1e-4:
        raise AssertionError(f"GCN gradients vs CPU: {grad_err:.3e}")
    for r, _ in runs:
        if not r["test_accuracy"] > 2 * chance:
            raise AssertionError(f"GCN test accuracy {r['test_accuracy']}")
    if forward_b <= 0 or launches["csr_spmm_transposed"] <= 0:
        raise AssertionError(f"kernel B not run both ways: {launches}")
    return {"gcn": launches}


def gat_model(device, f_in, n_classes, seed):
    """Velickovic et al. 2018's Pubmed GAT: 8 heads x 8 features,
    concatenated, ELU; then 8 output heads, averaged."""
    import torch

    from sgc_tpu_torch.models.gat import init_multi_head

    g = torch.Generator().manual_seed(seed)
    return (init_multi_head(g, 8, f_in, 8, device=device),
            init_multi_head(g, 8, 64, n_classes, device=device))


def gat_logits(layers, x, graph):
    from sgc_tpu_torch.models.gat import multi_head_gat

    h = multi_head_gat(layers[0], x, graph)
    return multi_head_gat(layers[1], h, graph, concat=False, activation=None)


def train_gat(layers, x, graph, target, steps, lr, weight_decay=0.0):
    """``steps`` Adam steps on the train rows' cross-entropy; returns the
    losses."""
    import torch

    from sgc_tpu_torch.train.loops import node_cross_entropy

    params = [p for m in layers for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = node_cross_entropy(gat_logits(layers, x, graph), *target)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [float(v) for v in losses]


def copy_layers(layers, device):
    from sgc_tpu_torch.models.gat import GATLayer

    return tuple(GATLayer(*(p.detach().to(device).clone() for p in (
        m.w, m.a_src, m.a_dst, m.bias))) for m in layers)


def phase_gat_pubmed(root, device) -> dict:
    """The two-layer GAT trained for 200 Adam epochs (lr 5e-3, weight
    decay 1e-3; the paper's dropout is not in the reference's layer) on
    the Pubmed-shape fixture: test accuracy above 2x chance; one gradient
    on the card held against a CPU copy at 1e-4. (Two runs giving the
    same bits is held on the Reddit-shape graph, ``gat_reddit``.)"""
    import torch

    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target
    from sgc_tpu_torch.train.metrics import accuracy
    from sgc_tpu_torch.utils.profiling import sync

    data = load_citation("pubmed", data_path=root, device=device)
    x, g = data.features, data.graph
    target = train_target(g.n_rows, data.idx_train,
                          data.labels[data.idx_train])
    init = gat_model(device, x.shape[1], data.n_classes, 11)
    epochs = 200

    cpu = load_citation("pubmed", data_path=root, device="cpu")
    cpu_target = train_target(cpu.graph.n_rows, cpu.idx_train,
                              cpu.labels[cpu.idx_train])
    grads = {}
    for name, layers, xx, gg, tt in (
            ("cuda", copy_layers(init, device), x, g, target),
            ("cpu", copy_layers(init, "cpu"), cpu.features, cpu.graph,
             cpu_target)):
        params = [p for m in layers for p in m.parameters()]
        grads[name] = param_grads(lambda: node_cross_entropy(
            gat_logits(layers, xx, gg), *tt), params)
    grad_err = max_rel_err(grads["cuda"], grads["cpu"])
    del cpu, cpu_target

    train_gat(copy_layers(init, device), x, g, target, 1, 5e-3, 1e-3)
    layers = copy_layers(init, device)          # after a warm step
    t0 = time.perf_counter()
    losses, launches = counted(
        lambda: train_gat(layers, x, g, target, epochs, 5e-3, 1e-3))
    sync(device)
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        logits = gat_logits(layers, x, g)
    run = {"train_s": train_s, "s_per_epoch": train_s / epochs,
           "first_loss": losses[0], "last_loss": losses[-1],
           "val_accuracy": accuracy(logits[data.idx_val],
                                    data.labels[data.idx_val]),
           "test_accuracy": accuracy(logits[data.idx_test],
                                     data.labels[data.idx_test])}
    chance = 1.0 / data.n_classes
    emit({"phase": "gat_pubmed", "heads": [8, 8], "hidden": 8,
          "epochs": epochs, "lr": 5e-3, "weight_decay": 1e-3, **run,
          "launches": launches,
          "launches_per_epoch": {k: v / epochs for k, v in launches.items()},
          "grad_vs_cpu_rel_err": grad_err, "grad_tolerance_rel": 1e-4,
          "chance": chance})
    if not grad_err <= 1e-4:
        raise AssertionError(f"GAT gradients vs CPU: {grad_err:.3e}")
    if not run["test_accuracy"] > 2 * chance:
        raise AssertionError(f"GAT test accuracy {run['test_accuracy']}")
    if min(launches[k] for k in ("csr_spmm", "csr_spmm_transposed",
                                 "sddmm")) <= 0:
        raise AssertionError(f"a kernel of the GAT path idle: {launches}")
    return launches


def phase_gat_reddit(data, device, reps) -> dict:
    """Three Adam steps of the same GAT on the Reddit-shape clustered
    graph (602 features, 41 classes), twice from one init (the same
    bits). During one step the backward's operands of kernel D and of
    the transposed kernel B are kept, at F = 8 (a hidden head) and F = 41
    (an output head); each is held against its plain version at 1e-5 and
    timed by CUDA events beside the forward kernel B on the same graph,
    with bounds and the same-function library calls
    (``torch.sparse.mm`` on the transposed CSR, ``sampled_addmm``)."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import autograd as ag
    from sgc_tpu_torch.ops.spmm import (
        sddmm,
        sddmm_plain,
        spmm_segment,
        spmm_segment_plain,
    )
    from sgc_tpu_torch.train.loops import train_target
    from sgc_tpu_torch.utils.profiling import sync

    graph, features, labels, idx_train = data
    g = graph.to(device)
    x = torch.as_tensor(features, device=device)
    n_classes = int(labels.max()) + 1
    target = train_target(g.n_rows, idx_train, torch.as_tensor(
        labels[idx_train], device=device))
    init = gat_model(device, x.shape[1], n_classes, 13)
    t0 = time.perf_counter()
    ag.transposed(g)
    transpose_s = time.perf_counter() - t0

    # keep the first backward operands at each width
    kept = {}
    real_sddmm, real_tr = ag.sddmm, ag.spmm_transposed

    def keep_sddmm(graph_, a, b):
        kept.setdefault(("d", a.shape[1]), (graph_, a.detach(), b.detach()))
        return real_sddmm(graph_, a, b)

    def keep_tr(graph_, vals, xx):
        if xx.shape[1] > 1:
            kept.setdefault(("bt", xx.shape[1]),
                            (graph_, vals.detach(), xx.detach()))
        return real_tr(graph_, vals, xx)

    runs = []
    for r in range(2):
        layers = copy_layers(init, device)
        if r == 0:
            ag.sddmm, ag.spmm_transposed = keep_sddmm, keep_tr
        try:
            train_gat(layers, x, g, target, 1, 5e-3)
        finally:
            ag.sddmm, ag.spmm_transposed = real_sddmm, real_tr
        sync(device)
        t0 = time.perf_counter()
        losses, launches = counted(
            lambda: train_gat(layers, x, g, target, 2, 5e-3))
        sync(device)
        runs.append({"step_s": (time.perf_counter() - t0) / 2,
                     "losses": losses, "launches_2_steps": launches,
                     "params": [p.detach() for m in layers
                                for p in m.parameters()]})
    bits = same_bits(runs[0].pop("params"), runs[1].pop("params"))

    widths = {}
    for F in (8, n_classes):
        _, a_d, b_d = kept[("d", F)]
        _, vals, gx = kept[("bt", F)]
        att = g.with_vals(vals)
        gt = ag.on_transpose(g, vals)
        # forward kernel B on this head's attention graph and h
        fwd = (lambda: spmm_segment(att, b_d))
        tr = (lambda: spmm_segment(gt, gx))
        tr_gather = (lambda: ag.spmm_transposed(g, att.vals, gx))
        dk = (lambda: sddmm(g, a_d, b_d))
        out = {}
        for name, fn, plain in (
                ("transposed_b", tr, lambda: spmm_segment_plain(gt, gx)),
                ("d", dk, lambda: sddmm_plain(g, a_d, b_d))):
            got, again = fn(), fn()
            abs_err, err = rel_err(got, plain())
            if not err <= TOLERANCE:
                raise AssertionError(f"GAT backward {name} at F={F} vs "
                                     f"plain: {err:.3e}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} at F={F}: launches differ")
            out[name] = {"max_abs_err": abs_err, "rel_err": err}
        csr_t, csr = csr_of(gt), csr_of(att)
        b_fwd, by_fwd = rf.b_bound(att, F)
        b_tr, by_tr = rf.b_bound(gt, F)
        d_ms, d_by, _, _ = rf.sddmm_bound(g, int(a_d.shape[1]), 4)
        out["forward_b"] = {"ms": time_ms(fwd, reps), "bound_ms": b_fwd,
                            "bound_by": by_fwd,
                            "library_ms": time_ms(
                                lambda: torch.sparse.mm(csr, b_d), reps),
                            "plain_ms": time_ms(
                                lambda: spmm_segment_plain(att, b_d), 1)}
        out["transposed_b"].update({
            "ms": time_ms(tr, reps),
            "with_vals_gather_ms": time_ms(tr_gather, reps),
            "bound_ms": b_tr, "bound_by": by_tr,
            "library_ms": time_ms(lambda: torch.sparse.mm(csr_t, gx), reps),
            "plain_ms": time_ms(lambda: spmm_segment_plain(gt, gx), 1)})
        out["d"].update({
            "ms": time_ms(dk, reps), "bound_ms": d_ms, "bound_by": d_by,
            "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
                csr, a_d, b_d.t(), beta=0.0), reps),
            "plain_ms": time_ms(lambda: sddmm_plain(g, a_d, b_d), 1)})
        widths[F] = out
        del csr, csr_t, gt, att
    # the segment sums at F = 1 (softmax denominators, their backward,
    # the edge scores' row and column sums): one lane of a warp works
    _, vals, _ = kept[("bt", 8)]
    ones = torch.ones((g.n_cols, 1), device=device)
    att = g.with_vals(vals)
    b1, by1 = rf.b_bound(att, 1)
    csr = csr_of(att)
    got = ag.row_sums(g, vals)
    _, err1 = rel_err(got, spmm_segment_plain(att, ones)[:, 0])
    if not err1 <= TOLERANCE:
        raise AssertionError(f"row sums at F=1 vs plain: {err1:.3e}")
    widths["1"] = {"row_sum": {
        "rel_err": err1, "ms": time_ms(lambda: ag.row_sums(g, vals), reps),
        "bound_ms": b1, "bound_by": by1,
        "library_ms": time_ms(lambda: torch.sparse.mm(csr, ones), reps)}}
    del csr, att
    kept.clear()
    emit({"phase": "gat_reddit", "nodes": g.n_rows, "nnz": g.nnz,
          "features": int(x.shape[1]), "classes": n_classes,
          "transpose_build_s": transpose_s, "runs": runs,
          "params_bit_equal": bits, "tolerance_rel": TOLERANCE,
          "widths": {str(k): v for k, v in widths.items()}})
    if not bits:
        raise AssertionError("two GAT runs on the Reddit graph differ")
    n = runs[0]["launches_2_steps"]
    if min(n[k] for k in ("csr_spmm", "csr_spmm_transposed", "sddmm")) <= 0:
        raise AssertionError(f"a kernel of the GAT path idle: {n}")
    return {"widths": widths, "launches": n}


def phase_deep_gcn(root, device) -> dict:
    """An 8-layer residual deep GCN (hidden 64) on the Pubmed-shape
    fixture: ``remat`` on and off give the same loss and gradient bits,
    the gradient of the same init on a CPU copy (plain kernels) agrees
    at 1e-4 of max, and a few Adam steps lower the loss."""
    import torch

    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.models.deep_gcn import (
        DeepGCN,
        deep_gcn_apply,
        init_deep_gcn,
    )
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target

    def loss_fn(model, data, remat):
        target = train_target(data.graph.n_rows, data.idx_train,
                              data.labels[data.idx_train])
        return lambda: node_cross_entropy(deep_gcn_apply(
            model, data.features, data.graph, remat=remat), *target)

    data = load_citation("pubmed", data_path=root, device=device)
    model = init_deep_gcn(torch.Generator().manual_seed(17),
                          data.features.shape[1], 64, data.n_classes,
                          n_layers=8, device=device)
    params = list(model.parameters())
    (on, launches) = counted(lambda: param_grads(
        loss_fn(model, data, True), params))
    off = param_grads(loss_fn(model, data, False), params)
    bits = same_bits(on, off)
    cpu_model = DeepGCN(*(p.detach().cpu().clone() for p in params))
    want = param_grads(loss_fn(cpu_model, load_citation(
        "pubmed", data_path=root, device="cpu"), False),
        list(cpu_model.parameters()))
    grad_err = max_rel_err(off, want)
    del cpu_model, want
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = []
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, data, True)()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    emit({"phase": "deep_gcn", "layers": 8, "hidden": 64, "residual": True,
          "remat_bit_equal": bits, "grad_vs_cpu_rel_err": grad_err,
          "grad_tolerance_rel": 1e-4, "losses": losses,
          "launches_one_step": launches})
    if not bits:
        raise AssertionError("remat on and off gave different bits")
    if not grad_err <= 1e-4:
        raise AssertionError(f"deep GCN gradients vs CPU: {grad_err:.3e}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"deep GCN loss did not fall: {losses}")
    if launches["csr_spmm_transposed"] <= 0:
        raise AssertionError(f"no backward kernel B: {launches}")
    return launches


def phase_tuning_cli(root, device) -> dict:
    """``cli.tuning.tune_citation`` on the Pubmed-shape fixture: 60 TPE
    evaluations, then ``grid=16``; the val accuracy above 2x chance."""
    from sgc_tpu_torch.cli import tuning

    runs, launches = {}, {}
    for name, kw in (("tpe", {}), ("grid16", {"grid": 16})):
        t0 = time.perf_counter()
        (best, val), launches[name] = counted(lambda: tuning.tune_citation(
            "pubmed", 2, 100, 0.2, 60, 42, root, device=device, **kw))
        runs[name] = {"weight_decay": best["weight_decay"],
                      "val_accuracy": val,
                      "seconds": time.perf_counter() - t0}
    emit({"phase": "tuning_cli", "runs": runs, "launches": launches,
          "chance": 1 / 3})
    for name, r in runs.items():
        if not r["val_accuracy"] > 2 / 3:
            raise AssertionError(f"tuning {name}: {r}")
    if any(n["csr_spmm"] <= 0 for n in launches.values()):
        raise AssertionError(f"kernel B never launched: {launches}")
    return launches


# the text path's gates: sparse vs dense as the reference's own test
# holds them (tests/test_pipeline_cli.py:374-378), and blockdense vs
# sparse to the bf16-cell bound relative to max (:333-336)
TEXT_RTOL, TEXT_ATOL = 2e-4, 2e-5
TEXT_BF16_TOLERANCE = 2e-2
TEXT_DATASET = "covid_19_production"
# the published COVID-19 graph: 24,019 nodes, 10.0M nnz (within 10%)
TEXT_NODES = 24_019
TEXT_NNZ = (9.0e6, 11.0e6)


def text_kernel_a(split, dargs, x, reps) -> dict:
    """Kernel A on the doc-word split at one phase chunk's width (the
    ``blockdense`` hop's dense term, precision "bf16"): two launches equal
    bit for bit and held against the plain product on bf16-rounded x at
    ``TOLERANCE``, timed beside its bound and the same-function library
    call (the cells' nonzeros as one CSR matrix against bf16-rounded x)."""
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import bf16_round

    got = bd.apply_cells(split, dargs, x, "bf16")
    again = bd.apply_cells(split, dargs, x, "bf16")
    abs_err, err = rel_err(got, bd.apply_cells_plain(split, dargs, x,
                                                     "bf16"))
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel A (doc-word split) vs plain: {err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError("kernel A (doc-word split): launches differ")
    del got, again
    ms = time_ms(lambda: bd.apply_cells(split, dargs, x, "bf16"), reps)
    plain_ms = time_ms(lambda: bd.apply_cells_plain(split, dargs, x, "bf16"),
                       1)
    csr = cells_csr(split, dargs, split.n_cells)
    xb = bf16_round(x)
    zero = x.new_zeros((split.n_rows, x.shape[1]))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, xb, beta=0.0), reps)
    del csr, xb, zero
    bound = rf.kernel_a_bound(split, dargs, split.n_cells, int(x.shape[1]),
                              1)
    return {"F": int(x.shape[1]), "cells": split.n_cells, "precision": "bf16",
            "max_abs_err": abs_err, "rel_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bound}


def phase_text_path(args, device, reps) -> dict:
    """The TextSGC path at the COVID-19 corpus's shape: a seeded corpus
    (9,187 docs, 31 classes, 14,832 words) -> ``cli.build_graph``
    (window 20, val 0.1, seed 42) -> ``load_corpus(subset="BCD")`` on
    the card -> ``text_structural_features`` at ``sparse`` (kernel B),
    ``blockdense`` (kernel A + kernel B) and ``dense``, each held against
    the others; kernel B at the phases' chunk widths and kernel A at
    2048 held against their plain versions and timed; then
    ``cli.textsgc.run`` (LBFGS 3 epochs, and Newton 8 steps), each twice
    with the same bits and test accuracy at least 2x chance,
    ``run_crossval`` at 2 folds and ``tune_text`` for 4 TPE evals."""
    import numpy as np
    import torch

    from sgc_tpu_torch.cli import crossval, textsgc, tuning
    from sgc_tpu_torch.cli.build_graph import build_and_export
    from sgc_tpu_torch.data.crossval import make_crossval_ids
    from sgc_tpu_torch.data.fixtures import COVID, write_text_corpus
    from sgc_tpu_torch.data.textcorpus import load_corpus
    from sgc_tpu_torch.ops import propagate as prop
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.utils.buildcache import clear_placed
    from sgc_tpu_torch.utils.config import TextConfig

    launches, info = {}, {}
    with scratch_dir() as root:
        t0 = time.perf_counter()
        fx = write_text_corpus(root, TEXT_DATASET, seed=args.seed, **COVID)
        info["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        built = build_and_export(str(fx["metadata"]), str(fx["corpus"]),
                                 TEXT_DATASET, root, window=20,
                                 val_fraction=0.1, seed=42)
        info["build_s"] = time.perf_counter() - t0
        adj = built["adjs"]["BCD"]
        info.update(nodes=adj.shape[0], adj_nnz=int(adj.nnz),
                    vocab=len(built["vocab"]), docs=fx["docs"],
                    tokens=fx["tokens"])
        del built, adj
        make_crossval_ids(fx["metadata"], root, TEXT_DATASET, n_folds=2)
        t0 = time.perf_counter()
        data = load_corpus(TEXT_DATASET, "BCD", root, device=device)
        info["load_s"] = time.perf_counter() - t0
        g, idx = data.graph, data.index_dict
        info["nnz"] = g.nnz
        auto = prop.text_impl(g, "auto")
        widths = {p: len(i) for p, i in idx.items()}
        chunks = {p: [min(prop.TEXT_CHUNK, w - i)
                      for i in range(0, w, prop.TEXT_CHUNK)]
                  for p, w in widths.items()}
        log(f"text: {info}")

        feats, impls = {}, {}
        for impl in ("sparse", "blockdense", "dense"):
            t0 = time.perf_counter()
            (feats[impl], secs), launches[impl] = counted(
                lambda: prop.text_structural_features(g, idx, 2, impl))
            impls[impl] = {"precompute_time": secs,
                           "wall_s": time.perf_counter() - t0,
                           "launches": launches[impl]}
            if impl == "blockdense":
                split, dargs = bd._split_cached(
                    g, min(max(widths.values()), prop.TEXT_CHUNK),
                    bd.DEFAULT_ROW_BLOCK, bd.DEFAULT_STRIPE, device)
                impls[impl].update(
                    cells=split.n_cells, dense_edges=split.dense_edges,
                    sparse_edges=split.sparse_edges,
                    dense_frac=split.dense_edges / g.nnz,
                    min_edges=split.min_edges,
                    cell_gb=split.cell_bytes / 1e9)
        n_chunks = sum(len(c) for c in chunks.values())
        checks = {}
        for p in idx:
            sp_, de, bdf = (feats[k][p] for k in ("sparse", "dense",
                                                  "blockdense"))
            if sp_.shape != de.shape or sp_.shape != bdf.shape or \
                    sp_.shape[0] != widths[p]:
                raise AssertionError(f"text {p}: shapes {sp_.shape}, "
                                     f"{de.shape}, {bdf.shape}")
            _, dense_err = rel_err(sp_, de)
            _, bd_err = rel_err(bdf, sp_)
            checks[p] = {"shape": list(sp_.shape),
                         "sparse_vs_dense_rel_err": dense_err,
                         "sparse_vs_dense_allclose": bool(torch.allclose(
                             sp_, de, rtol=TEXT_RTOL, atol=TEXT_ATOL)),
                         "blockdense_vs_sparse_rel_err": bd_err}
        del feats, sp_, de, bdf

        # kernel B at the phases' chunk widths on their own operands (the
        # sparse hop's inputs), kernel A at the widest on the split
        operands = {str(chunks["train"][0]): ("train", 0),
                    str(chunks["train"][-1]):
                    ("train", sum(chunks["train"][:-1])),
                    str(widths["val"]): ("val", 0),
                    str(widths["test"]): ("test", 0)}
        b_widths = {}
        for name, (p, start) in operands.items():
            cols = np.asarray(idx[p])[start:start + prop.TEXT_CHUNK]
            x = torch.from_numpy(prop._sliced_columns(g, cols)).to(device)
            b_widths[name] = b_width(f"doc-word graph, {p} chunk", g, x,
                                     None, reps)
            if (p, start) == ("train", 0):
                a_text = text_kernel_a(split, dargs, x, reps)
                if dargs.rest is not None:
                    b_widths[f"{name}_split_remainder"] = b_width(
                        "doc-word split remainder", dargs.rest, x,
                        bd.apply_cells(split, dargs, x, "bf16"), reps)
            del x
        del split, dargs
        clear_placed()

        runs = {}
        for name, trainer in (("lbfgs", "lbfgs"), ("newton", "newton")):
            res = []
            for _ in range(2):
                t0 = time.perf_counter()
                r, launches[name] = counted(lambda: textsgc.run(
                    TextConfig(dataset=TEXT_DATASET, seed=args.seed,
                               tuned=True), data_path=root, trainer=trainer,
                    device=device))
                r["wall_s"] = time.perf_counter() - t0
                res.append(r)
            a, b = res
            same = (torch.equal(a["params"].w, b["params"].w)
                    and np.array_equal(a["predictions"], b["predictions"]))
            runs[name] = {k: a[k] for k in (
                "impl", "train_accuracy", "val_accuracy", "test_accuracy",
                "precompute_time", "train_time", "total_time", "wall_s")}
            runs[name].update(second_wall_s=b["wall_s"], same_bits=same,
                              second_total_time=b["total_time"])
            del res, a, b, r
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):   # its fold lines
            cv, launches["crossval"] = counted(
                lambda: crossval.run_crossval(
                    TEXT_DATASET, folds=2, tuned=True, seed=args.seed,
                    data_path=root, results_dir=None, device=device))
        cv_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (best, val), launches["tune_text"] = counted(lambda: tuning.tune_text(
            TEXT_DATASET, 2, 3, 4, args.seed, root, "BCD", device=device))
        tune_s = time.perf_counter() - t0
        del data, g
    chance = 1.0 / COVID["n_classes"]
    emit({"phase": "text_path", "fixture": info, "phase_widths": widths,
          "chunk_widths": chunks, "chunks": n_chunks, "impls": impls,
          "auto_impl": auto, "checks": checks,
          "tolerance": {"sparse_vs_dense": [TEXT_RTOL, TEXT_ATOL],
                        "blockdense_vs_sparse_rel": TEXT_BF16_TOLERANCE},
          "kernel_b_widths": b_widths, "kernel_a_2048": a_text,
          "runs": runs, "chance": chance,
          "crossval": {"seconds": cv_s,
                       "accuracy_mean": cv["accuracy_mean"],
                       "f1_weighted_mean": cv["f1_weighted_mean"]},
          "tune_text": {"seconds": tune_s, "max_evals": 4,
                        "weight_decay": best["weight_decay"],
                        "val_accuracy": val},
          "launches": launches})
    if info["nodes"] != TEXT_NODES or not (
            TEXT_NNZ[0] <= info["nnz"] <= TEXT_NNZ[1]):
        raise AssertionError(f"text fixture off the COVID shape: {info}")
    for p, c in checks.items():
        if not c["sparse_vs_dense_allclose"]:
            raise AssertionError(f"text {p}: sparse vs dense {c}")
        if not c["blockdense_vs_sparse_rel_err"] <= TEXT_BF16_TOLERANCE:
            raise AssertionError(f"text {p}: blockdense vs sparse {c}")
    rest = impls["blockdense"]["sparse_edges"] > 0
    want = {"sparse": (n_chunks, 0),
            "blockdense": (n_chunks if rest else 0, n_chunks),
            "dense": (0, 0)}
    for impl, (n_b, n_a) in want.items():
        got = (launches[impl]["csr_spmm"], launches[impl]["blockdense_cells"])
        if got != (n_b, n_a):
            raise AssertionError(f"text {impl}: kernel B, A launches {got}, "
                                 f"want {(n_b, n_a)}")
    for name, r in runs.items():
        if r["impl"] != auto or not r["same_bits"]:
            raise AssertionError(f"textsgc {name}: {r}")
        if not r["test_accuracy"] >= 2 * chance:
            raise AssertionError(f"textsgc {name}: test acc {r}")
        if launches[name]["csr_spmm"] != (n_chunks if auto == "sparse"
                                          else 0):
            raise AssertionError(f"textsgc {name}: {launches[name]}")
    if not val > 2 * chance or (auto == "sparse"
                                and launches["tune_text"]["csr_spmm"] <= 0):
        raise AssertionError(f"tune_text: {best} {val}")
    return {"launches": launches, "kernel_a_2048": a_text,
            "kernel_b_widths": b_widths}


SERVE_BATCHES = (1, 8, 64, 512, 1024)
SERVE_REQUESTS = 30
SERVE_FANOUTS = (25, 10)
# int8 predictions agreeing with f32 ones, over the sweep's rows
INT8_AGREEMENT = 0.99


class _Interrupted(Exception):
    """Stands for a crash of the propagation between two hops."""


def serve_store(args, device) -> dict:
    """The served store: ``synthetic_reddit`` at ``args.scale`` on the
    card, ``sgc_precompute(degree=2)`` (kernel B), then the same hops
    through ``propagate_with_checkpoints``, stopped after its first hop
    and resumed (equal bit for bit), and a Newton head on the train rows
    through ``save_params`` / ``load_params``."""
    import torch

    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.ops import spmm as spmm_mod
    from sgc_tpu_torch.ops.propagate import sgc_precompute
    from sgc_tpu_torch.train.loops import train_linear
    from sgc_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    graph, raw, labels, idx_train = synthetic_reddit(args.scale,
                                                     seed=args.seed)
    data_s = time.perf_counter() - t0
    gd = graph.to(device)
    x = torch.as_tensor(raw, device=device)
    (store, precompute_s), pre = counted(lambda: sgc_precompute(x, gd, 2))

    real, calls = spmm_mod.spmm, []

    def crash_in_second_hop(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise _Interrupted
        return real(*a, **k)

    def interrupted(root):
        spmm_mod.spmm = crash_in_second_hop
        try:
            ckpt.propagate_with_checkpoints(x, gd, 2, root)
        except _Interrupted:
            return
        finally:
            spmm_mod.spmm = real
        raise AssertionError("the propagation was not interrupted")

    with scratch_dir() as root:
        t0 = time.perf_counter()
        _, stopped = counted(lambda: interrupted(root))
        resumed, resume = counted(
            lambda: ckpt.propagate_with_checkpoints(x, gd, 2, root))
        checkpoint_s = time.perf_counter() - t0
        if (stopped["csr_spmm"], resume["csr_spmm"]) != (1, 1):
            raise AssertionError(f"hops before / after the stop: "
                                 f"{stopped}, {resume}")
        if not torch.equal(resumed, store):
            raise AssertionError("resumed propagation differs from the "
                                 "uninterrupted one")
        del resumed

        rows = torch.as_tensor(idx_train, device=device)
        y = torch.as_tensor(labels[idx_train], device=device).long()
        t0 = time.perf_counter()
        fit, _ = train_linear(
            init_sgc(torch.Generator().manual_seed(args.seed),
                     store.shape[1], int(labels.max()) + 1, device=device),
            store[rows], y, trainer="newton")
        fit_s = time.perf_counter() - t0
        ckpt.save_params(os.path.join(root, "head.npz"), fit)
        head = ckpt.load_params(os.path.join(root, "head.npz"),
                                device=device)
    if not (torch.equal(head.w, fit.w) and torch.equal(head.b, fit.b)):
        raise AssertionError("the loaded head differs from the saved one")
    train_acc = float((head(store[rows]).argmax(1) == y).float().mean())
    return {"graph": gd, "raw": x, "store": store, "head": head,
            "launches": {"precompute": pre, "stopped_after_hop_1": stopped,
                         "resumed": resume},
            "info": {"nodes": graph.n_rows, "nnz": graph.nnz,
                     "features": int(store.shape[1]),
                     "classes": int(head.w.shape[1]),
                     "train": len(idx_train), "data_s": data_s,
                     "precompute_s": precompute_s,
                     "checkpoint_s": checkpoint_s, "fit_s": fit_s,
                     "train_acc": train_acc}}


def int8_check(got, want, ids, int8_engine) -> dict:
    """int8 logits ``got`` against f32 logits ``want`` on rows ``ids``:
    every logit within the dequantization bound (half a quantization step
    per feature, weighted by |w|, plus f32 slack), every row whose f32
    top-two margin clears twice that bound predicting the same class, and
    the share of rows predicting the same class."""
    import numpy as np
    import torch

    step = int8_engine._scales.index_select(
        0, torch.as_tensor(ids, device=int8_engine.device)).cpu().numpy()
    w_abs = int8_engine.params.w.abs().sum(0).cpu().numpy()
    bound = 0.5 * step * w_abs[None, :] + 1e-5 * np.abs(want).max()
    err = np.abs(got - want)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * bound.max(axis=1)
    same = got.argmax(1) == want.argmax(1)
    out = {"rows": int(len(ids)), "agreement": float(same.mean()),
           "margin_clear_rows": int(clear.sum()),
           "margin_clear_agreement": float(same[clear].mean()),
           "max_err_over_bound": float((err / bound).max())}
    if not (err <= bound).all():
        raise AssertionError(f"int8 logits outside the bound: {out}")
    if not same[clear].all():
        raise AssertionError(f"int8 flips a clear-margin row: {out}")
    return out


def http_check(engine, ids) -> dict:
    """The HTTP endpoint on port 0 in a thread: /predict,
    /predict_logits, /predict_batch and /healthz, each answer equal to
    the engine's direct one."""
    import threading
    import urllib.request

    import numpy as np

    from sgc_tpu_torch.serve.http import serve

    server = serve(engine, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    ids = [int(i) for i in ids]
    batches = [ids[:8], [], ids[8:72], ids[:1]]
    t0 = time.perf_counter()
    try:
        pred = call("/predict", {"node_ids": ids})["predictions"]
        logits = call("/predict_logits", {"node_ids": ids[:64]})["logits"]
        batch = call("/predict_batch", {"batches": batches})["predictions"]
        health = call("/healthz")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    wall_s = time.perf_counter() - t0
    checks = {
        "predict": pred == engine.predict(ids).tolist(),
        "predict_logits": np.array_equal(np.asarray(logits, np.float32),
                                         engine.predict_logits(ids[:64])),
        "predict_batch": batch == [engine.predict(b).tolist() if b else []
                                   for b in batches],
        "healthz": health["status"] == "ok" and health["requests"] >= 4,
        "stopped": not thread.is_alive()}
    if not all(checks.values()):
        raise AssertionError(f"HTTP answers differ: {checks}")
    return {"checks": checks, "wall_s": wall_s, "healthz": health}


def phase_serve_path(args, device, card, reps) -> dict:
    """Serving a trained head on the card: the store, checkpoints and
    head of :func:`serve_store`; ``InferenceEngine`` f32 and int8 over
    the store and inductive over the graph and raw features (fanouts 25,
    10); ``cli.serve._bench_variant`` over batches 1 to 1024, 30 requests
    each, blocking and pipelined at depth 2; then the checks: pipelined
    equal to blocking bit for bit (transductive), f32 logits within 1e-5
    of max of a float64 product, int8 within its dequantization bound
    and agreeing on at least 99% of the rows, the inductive engine's
    first call the head on the tree its generator draws, that tree's
    reduction within 1e-5 of max of a float64 recomputation, and the
    HTTP endpoint's answers equal to the engine's."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.cli.serve import _bench_variant, dispatch_floor_ms
    from sgc_tpu_torch.ops import sampling
    from sgc_tpu_torch.serve import EngineConfig, InferenceEngine

    t_phase = time.perf_counter()
    built = serve_store(args, device)
    store, head = built["store"], built["head"]
    t0 = time.perf_counter()
    engines = {
        "f32": InferenceEngine(head, features=store, device=device),
        "int8": InferenceEngine(head, features=store, device=device,
                                config=EngineConfig(quantize_int8=True)),
        "inductive": InferenceEngine(
            head, graph=built["graph"], raw_features=built["raw"],
            device=device, config=EngineConfig(fanouts=SERVE_FANOUTS,
                                               seed=args.seed,
                                               warmup=False))}
    engines_s = time.perf_counter() - t0
    n = store.shape[0]
    rng = np.random.default_rng(args.seed)

    # the inductive engine's first call against the tree its generator
    # draws, and that tree's reduction against float64
    ind = engines["inductive"]
    ids = rng.integers(0, n, SERVE_BATCHES[-1])
    first = ind.predict_logits(ids)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    dev_ids = torch.as_tensor(ids.astype(np.int32), device=device)
    fr, ws = sampling.sample_tree(built["graph"], dev_ids, gen,
                                  SERVE_FANOUTS)
    est = sampling.reduce_tree(built["raw"], fr, ws, SERVE_FANOUTS)
    if not np.array_equal(first, head(est).cpu().numpy()):
        raise AssertionError("inductive engine != head on its tree")
    leaves = built["raw"].cpu().numpy()[fr[-1].cpu().numpy()].astype(
        np.float64).reshape(len(ids), *SERVE_FANOUTS, -1)
    w0, w1 = (w.cpu().numpy().astype(np.float64).reshape(
        len(ids), *SERVE_FANOUTS[:t + 1]) for t, w in enumerate(ws))
    est64 = np.einsum("bk,bkf->bf", w0, np.einsum(
        "bkl,bklf->bkf", w1, leaves) / SERVE_FANOUTS[1]) / SERVE_FANOUTS[0]
    del leaves
    tree_abs, tree_err = rel_err(est.double().cpu(), torch.from_numpy(est64))
    if not tree_err <= TOLERANCE:
        raise AssertionError(f"tree reduction vs float64: {tree_err:.3e}")
    gather_bytes = int(fr[-1].numel()) * int(store.shape[1]) * 4
    reduce_ms = time_ms(lambda: sampling.reduce_tree(
        built["raw"], fr, ws, SERVE_FANOUTS), reps)
    sample_ms = time_ms(lambda: sampling.sample_tree(
        built["graph"], dev_ids, gen, SERVE_FANOUTS), reps)
    del fr, ws, est

    floor_ms = dispatch_floor_ms(device)
    sweep, launches = {}, dict(built["launches"])
    for name, eng in engines.items():
        sweep[name], launches[f"sweep_{name}"] = counted(
            lambda: _bench_variant(name, eng, SERVE_BATCHES,
                                   SERVE_REQUESTS, pipeline_depth=2))

    # f32 vs float64 and int8 vs f32 on fresh rows (the sweep held the
    # pipelined outputs to the blocking ones)
    w64 = head.w.double().cpu().numpy()
    b64 = head.b.double().cpu().numpy()
    store_host = store.cpu().numpy()
    f32_err = 0.0
    served = {"ids": [], "f32": [], "int8": []}
    for b in SERVE_BATCHES:
        batches = [rng.integers(0, n, b) for _ in range(SERVE_REQUESTS)]
        served["ids"].extend(batches)
        for name in ("f32", "int8"):
            served[name].extend(engines[name].predict_logits(i)
                                for i in batches)
    for i, got in zip(served["ids"], served["f32"]):
        want = store_host[i].astype(np.float64) @ w64 + b64
        f32_err = max(f32_err, float(np.abs(got - want).max())
                      / float(np.abs(want).max()))
    del store_host
    int8 = int8_check(np.concatenate(served["int8"]),
                      np.concatenate(served["f32"]),
                      np.concatenate(served["ids"]), engines["int8"])
    http = http_check(engines["f32"], rng.integers(0, n, 96))
    bitwise = all(r["pipelined_bitwise_equal"] for rows in sweep.values()
                  for r in rows if "pipelined_bitwise_equal" in r)

    emit({"phase": "serve_path", "nvidia_smi": card, **built["info"],
          "engines_s": engines_s, "dispatch_floor_ms": floor_ms,
          "requests_per_batch": SERVE_REQUESTS, "pipeline_depth": 2,
          "sweep": {name: [{k: r[k] for k in (
              "batch", "p50_ms", "p99_ms", "rows_per_s", "p50_ms_pipelined",
              "p99_ms_pipelined", "rows_per_s_pipelined")}
              for r in rows] for name, rows in sweep.items()},
          "pipelined_bitwise_equal": bitwise,
          "f32_vs_float64_rel_err": f32_err, "tolerance_rel": TOLERANCE,
          "int8": int8, "inductive": {
              "batch": len(ids), "fanouts": SERVE_FANOUTS,
              "leaf_rows": gather_bytes // (4 * int(store.shape[1])),
              "gather_bytes": gather_bytes, "reduce_ms": reduce_ms,
              "sample_ms": sample_ms, "gather_bound_ms":
                  gather_bytes / rf.PEAK_HBM_BYTES * 1e3,
              "tree_vs_float64_abs_err": tree_abs,
              "tree_vs_float64_rel_err": tree_err},
          "http": http, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    if not bitwise:
        raise AssertionError("pipelined logits differ from blocking ones")
    if not f32_err <= TOLERANCE:
        raise AssertionError(f"f32 logits vs float64: {f32_err:.3e}")
    if not int8["agreement"] >= INT8_AGREEMENT:
        raise AssertionError(f"int8 agreement {int8['agreement']:.4f}")
    if launches["precompute"]["csr_spmm"] != 2:
        raise AssertionError(f"precompute launches: {launches}")
    return launches


def phase_train_paths(args, device) -> dict:
    """The train-through-the-graph paths on one Pubmed-shape fixture."""
    from sgc_tpu_torch.data.fixtures import PUBMED, write_planetoid

    with scratch_dir() as root:
        write_planetoid(root, "pubmed", **PUBMED, seed=args.seed)
        gcn = phase_gcn_cli(root, device)
        gat = phase_gat_pubmed(root, device)
        deep = phase_deep_gcn(root, device)
        tune = phase_tuning_cli(root, device)
    return {"gcn_cli": gcn, "gat_train": {"pubmed_200_epochs": gat},
            "deep_gcn": {"one_step": deep}, "tuning_cli": tune}


# ------------------------------------------- the text baselines and prep

SEQ_DEFAULTS = dict(dim=256, heads=4, layers=4, max_len=256,
                    vocab_size=30_000, batch_size=32)
# relative to max|CPU|: the bf16 recipe. The operands and the weight
# gradients are bf16 values; where the card's f32 sums before a rounding
# differ from the CPU's (order), an element lands one bf16 step away, at
# most 2^-7 of its magnitude, so of the leaf's max (2^-7 exactly was read
# on the H100); the margin is for the f32 leaves downstream of such a step
SEQ_TOLERANCE = 2.0 ** -7 * 1.125
SEQ_SAME_BITS_STEPS = 6
# the sequence CLI's epochs here (its default is 4; cut for the smoke's
# time, never the widths)
SEQ_EPOCHS = 1
# word2vec's epochs here (the CLI's default is 5; cut for the smoke's
# time, each epoch 1,386 steps at the COVID-19 shape), and the learning rate
# and epochs of the fit whose vectors feed the graph: at the CLI's 0.025
# the batched update (each word's gradients summed over a batch of 8192
# pairs) diverges on this corpus, in the reference too
W2V_EPOCHS = 1
W2V_FINITE_LR = 0.0025


def seq_grads(model, ids, mask, y, w):
    """``[logits, grad of each parameter]`` of one dropout-free step."""
    from sgc_tpu_torch.models.transformer import transformer_apply
    from sgc_tpu_torch.train.sequence import weighted_cross_entropy

    for p in model.parameters():
        p.grad = None
    logits = transformer_apply(model, ids, mask)
    weighted_cross_entropy(logits, y, w).backward()
    return [logits.detach()] + [p.grad.clone() for p in model.parameters()]


def phase_sequence_path(root, fx, device, reps) -> dict:
    """The transformer baseline at the sequence CLI's full width (dim 256,
    4 heads, 4 layers, max_len 256, vocab 30,000, batch 32) on the
    COVID-19-shape corpus: ``cli.sequence.run`` at its defaults but
    ``SEQ_EPOCHS`` (dropout 0.1), timed a step on the card (CUDA events
    after each step; the first apart) and at predict, test accuracy at
    least 2x chance; two short trainings from one init, seed and batch order give
    the same bits; one step's logits and gradients held against a CPU
    copy at ``SEQ_TOLERANCE``; a batch with an empty doc gives finite
    logits. The token-embedding gradient is kernel B
    (``ops.autograd.GatherRowsFn``), one launch a step, held against its
    plain version on the operands of one step (``seq_embedding_width``)."""
    import copy

    import numpy as np
    import torch

    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.cli import sequence as cli
    from sgc_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
        transformer_apply,
    )
    from sgc_tpu_torch.textgraph.graph import TextCorpus
    from sgc_tpu_torch.train import sequence as seq

    args = cli.parser().parse_args([
        "--metadata", str(fx["metadata"]), "--corpus", str(fx["corpus"]),
        "--epochs", str(SEQ_EPOCHS), "--device", str(device)])
    marks, predict_s = [], []
    real_step, real_predict = seq.train_step, cli.predict_sequence

    def timed_step(*a, **kw):
        if not marks:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[0].record()
        out = real_step(*a, **kw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return out

    def timed_predict(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_predict(*a, **kw)
        predict_s.append(time.perf_counter() - t0)
        return out

    seq.train_step, cli.predict_sequence = timed_step, timed_predict
    try:
        t0 = time.perf_counter()
        res, launches_cli = counted(lambda: cli.run(args))
        wall = time.perf_counter() - t0
    finally:
        seq.train_step, cli.predict_sequence = real_step, real_predict
    steps = len(marks) - 1
    first_ms = marks[0].elapsed_time(marks[1])
    step_ms = marks[1].elapsed_time(marks[-1]) / (steps - 1)
    tc = TextCorpus.from_files(fx["metadata"], fx["corpus"])
    train_docs = [d for d, p in zip(tc.doc_tokens, tc.phases)
                  if p == "train"]
    real_tokens = sum(min(len(d), args.max_len) for d in train_docs)
    chance = 1.0 / res["n_classes"]

    # two short trainings from one init: the same bits
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, n_classes=res["n_classes"],
        max_len=args.max_len, dim=args.dim, n_heads=args.heads,
        n_layers=args.layers, dropout=args.dropout)
    init = init_transformer(cfg, torch.Generator(device=device).manual_seed(
        7), device)
    labels = np.arange(len(train_docs)) % res["n_classes"]
    n_docs = SEQ_SAME_BITS_STEPS * args.batch_size
    tcfg = seq.SeqTrainConfig(lr=args.lr, epochs=1, dropout=args.dropout)
    fits = [counted(lambda: seq.train_sequence_classifier(
        train_docs[:n_docs], labels[:n_docs], cfg, tcfg,
        params=copy.deepcopy(init), device=device)) for _ in range(2)]
    bits = same_bits(list(fits[0][0][0].parameters()),
                     list(fits[1][0][0].parameters()))
    launches_bits = fits[0][1]
    del fits

    # kernel B on the embedding gradient of the first batch; then one
    # step on the card against a CPU copy, with an empty doc
    vocab = seq.build_seq_vocab(train_docs, args.vocab_size)
    ids, mask = seq.encode_batch(train_docs[:args.batch_size], vocab,
                                 args.max_len)
    y = torch.from_numpy(labels[:args.batch_size])
    w = torch.ones(args.batch_size)
    width = seq_embedding_width(init, *(t.to(device) for t in (
        torch.from_numpy(ids), torch.from_numpy(mask), y, w)), reps)
    ids[3], mask[3] = 0, 0.0                      # an empty doc
    outs = []
    for dev in (device, torch.device("cpu")):
        m = copy.deepcopy(init).to(dev)
        outs.append(seq_grads(m, torch.from_numpy(ids).to(dev),
                              torch.from_numpy(mask).to(dev), y.to(dev),
                              w.to(dev)))
    logit_err = rel_err(outs[0][0].cpu(), outs[1][0])[1]
    grad_err = max_rel_err(outs[0][1:], outs[1][1:])
    with torch.no_grad():
        empty = transformer_apply(init, torch.from_numpy(ids).to(device),
                                  torch.from_numpy(mask).to(device))
    empty_finite = bool(torch.isfinite(empty).all())
    profile = seq_step_profile(init, tcfg, ids, mask, y, w, device)
    del outs, init, empty

    info = {"phase": "sequence_path", "config": {k: getattr(args, k) for k in (
                *SEQ_DEFAULTS, "epochs", "lr", "dropout")},
            "train_docs": len(train_docs), "classes": res["n_classes"],
            "steps": steps, "first_step_ms": first_ms, "step_ms": step_ms,
            "step_flop": seq_step_flops(args, res["n_classes"]),
            "step_bound_ms": seq_step_flops(args, res["n_classes"])
            / rf.PEAK_FP32_FLOPS * 1e3,
            "real_tokens_per_s": real_tokens * args.epochs
            / (step_ms * steps / 1e3),
            "padded_tokens_per_s": args.batch_size * args.max_len
            / (step_ms / 1e3),
            "predict_ms": predict_s[0] * 1e3, "wall_s": wall,
            "test_accuracy": res["test_accuracy"],
            "f1_weighted": res["f1_weighted"], "chance": chance,
            "same_bits": bits, "same_bits_steps": SEQ_SAME_BITS_STEPS,
            "logits_vs_cpu_rel_err": logit_err,
            "grads_vs_cpu_rel_err": grad_err,
            "tolerance_rel": SEQ_TOLERANCE,
            "empty_doc_logits_finite": empty_finite,
            "step_profile": profile, "kernel_b_width": width,
            "launches": {"cli": launches_cli, "same_bits": launches_bits}}
    emit(info)
    if not res["test_accuracy"] >= 2 * chance:
        raise AssertionError(f"sequence test accuracy {res}")
    if not bits:
        raise AssertionError("two transformer trainings gave other bits")
    if not (logit_err <= SEQ_TOLERANCE and grad_err <= SEQ_TOLERANCE):
        raise AssertionError(f"transformer step vs CPU: {logit_err:.3e}, "
                             f"{grad_err:.3e}")
    if not empty_finite:
        raise AssertionError("an empty doc gave non-finite logits")
    # the token-embedding gradient: one kernel-B launch a step
    if launches_cli["csr_spmm"] != steps:
        raise AssertionError(f"sequence path: {launches_cli}, {steps} steps")
    return {"launches": info["launches"], "width": width}


def seq_embedding_width(model, ids, mask, y, w, reps) -> dict:
    """Kernel B on the token-embedding gradient of one dropout-free step
    at full width: the operands ``GatherRowsFn``'s backward hands it
    (``scatter_graph`` of the batch's ids over the vocabulary, the output
    gradient's B*L rows; front padding makes the PAD id's row the hub),
    taken from the step, then ``b_width``, the plain version's time and
    ``index_add_`` (the library call for the same sum)."""
    import copy

    import torch

    from sgc_tpu_torch.ops import autograd
    from sgc_tpu_torch.ops.spmm import spmm_segment_plain

    taken, real = [], autograd.spmm_segment

    def take(graph, x, dense=None):
        taken.append((graph, x))
        return real(graph, x, dense)

    autograd.spmm_segment = take
    try:
        seq_grads(copy.deepcopy(model), ids, mask, y, w)
    finally:
        autograd.spmm_segment = real
    (g, rows), = taken
    width = b_width("transformer token-embedding gradient", g, rows, None,
                    reps)
    width["csr_mm_ms"] = width.pop("library_ms")
    zeros = torch.zeros((g.n_rows, rows.shape[1]), device=rows.device)
    flat = ids.reshape(-1).long()
    width["library_ms"] = time_ms(lambda: zeros.index_add(0, flat, rows),
                                  reps)
    width["plain_ms"] = time_ms(lambda: spmm_segment_plain(g, rows, None), 2)
    return width


def seq_step_profile(init, tcfg, ids, mask, y, w, device,
                     steps: int = 5) -> dict:
    """``torch.profiler`` over ``steps`` training steps of one full-width
    batch (after two warm ones): the window's wall time, the device time
    of every kernel summed (one stream, so the busy share is their ratio)
    and the eight kernels that take the most."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgc_tpu_torch.train import sequence as seq

    m = copy.deepcopy(init)
    opt = torch.optim.Adam(m.parameters(), lr=tcfg.lr)
    gen = torch.Generator(device=device).manual_seed(5)
    batch = [torch.from_numpy(a).to(device) for a in (ids, mask)] + [
        y.to(device), w.to(device)]

    def run(n):
        for _ in range(n):
            seq.train_step(m, opt, *batch, tcfg, generator=gen)
        torch.cuda.synchronize()

    run(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "busy_share": busy_us / 1e6 / wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [{"name": e.key[:80], "count": e.count / steps,
                     "ms_per_step": e.self_device_time_total / 1e3 / steps}
                    for e in top]}


def seq_step_flops(args, n_classes) -> float:
    """The products of one training step: forward (QKVO, MLP, attention
    scores and context, head) and twice that backward."""
    b, l, d = args.batch_size, args.max_len, args.dim
    per_layer = 2 * b * l * d * (4 * d + 8 * d) + 2 * 2 * b * l * l * d
    fwd = args.layers * per_layer + 2 * b * d * n_classes
    return 3.0 * fwd


def phase_word2vec_path(root, fx, device, reps) -> dict:
    """``cli.word2vec.run`` at its defaults (dim 100, window 5, 5
    negatives, batch 8192, lr 0.025) but ``W2V_EPOCHS`` on the
    COVID-19-shape corpus, once (the reference's batched update diverges
    at this lr: the non-finite rows are counted), then twice at
    ``W2V_FINITE_LR``, which stays finite: the two finite fits give the
    same bits. Pairs, steps, ms a step and the whole fit, two kernel-B
    launches a step. The finite fit's ``.npz`` feeds
    ``cli.build_graph --embeddings`` and its tables give the operands of
    one step's updates
    (``sgns_updates``: the out table's contexts and negatives, the in
    table's centers): kernel B at F = 100 held against its plain version
    at ``TOLERANCE`` and timed beside its bound, ``torch.addmm`` with a
    CSR matrix and ``index_add_`` (the library call for the same sum)."""
    import numpy as np
    import torch

    from sgc_tpu_torch.cli import word2vec as cli
    from sgc_tpu_torch.cli.build_graph import build_and_export
    from sgc_tpu_torch.ops.spmm import spmm_segment_plain
    from sgc_tpu_torch.textgraph import word2vec as w2v

    fits, launches = [], []
    runs = ([], ["--lr", str(W2V_FINITE_LR)], ["--lr", str(W2V_FINITE_LR)])
    for k, extra in enumerate(runs):
        args = cli.parser().parse_args([
            "--corpus", str(fx["corpus"]), "--out",
            os.path.join(root, f"w2v{k}"), "--epochs", str(W2V_EPOCHS),
            "--device", str(device)] + extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, n = counted(lambda: cli.run(args))
        fits.append((model, time.perf_counter() - t0))
        launches.append(n)
    cfg = w2v.Word2VecConfig(epochs=W2V_EPOCHS)
    docs = cli.read_docs(fx["corpus"])
    pairs = w2v.skipgram_pairs(docs, fits[0][0].word_id, cfg.window)
    steps = cfg.epochs * (len(pairs) // cfg.batch_size)
    v0, vf, vf2 = (f.vectors for f, _ in fits)
    bits = np.array_equal(vf.view(np.int32), vf2.view(np.int32))
    nonfinite = [int((~np.isfinite(v).all(axis=1)).sum()) for v in (v0, vf)]

    # one step's operands: a batch of a permutation, the finite fit's
    # table (and its reverse for the out table)
    gen = torch.Generator(device=device).manual_seed(3)
    vecs = torch.from_numpy(vf).to(device)
    out_emb = vecs.flip(0).contiguous()
    pick = torch.from_numpy(np.random.default_rng(3).permutation(len(pairs))[
        :cfg.batch_size]).to(device)
    batch = torch.from_numpy(pairs).to(device)[pick]
    cdf = w2v.noise_cdf(w2v.build_vocab(docs)[2], device)
    (g_in, rows_in), (g_out, rows_out), _ = w2v.sgns_updates(
        vecs, out_emb, batch[:, 0], batch[:, 1],
        w2v.draw_uniforms(gen, cfg.batch_size, cfg.negatives), cdf, cfg.lr)
    widths = {"100": b_width("word2vec out-table update", g_out, rows_out,
                             out_emb, reps),
              "100_in": b_width("word2vec in-table update", g_in, rows_in,
                                vecs, reps)}
    for (name, g, rows, table) in (("100", g_out, rows_out, out_emb),
                                   ("100_in", g_in, rows_in, vecs)):
        # the same sum by the library: index_add_ (float atomics)
        ids, x = g.rows.long(), rows[g.cols.long()]
        w = widths[name]
        w["csr_addmm_ms"] = w.pop("library_ms")
        w["library_ms"] = time_ms(
            lambda: table.index_add(0, ids, x, alpha=-cfg.lr), reps)
        w["plain_ms"] = time_ms(lambda: spmm_segment_plain(g, rows, table),
                                2)
    del vecs, out_emb, batch, g_in, g_out, rows_in, rows_out

    t0 = time.perf_counter()
    built = build_and_export(str(fx["metadata"]), str(fx["corpus"]),
                             TEXT_DATASET, os.path.join(root, "emb_graph"),
                             window=20, val_fraction=0.1, seed=42,
                             embeddings=os.path.join(root, "w2v1.npz"))
    build_s = time.perf_counter() - t0
    adj = built["adjs"]["BCD"]
    adj_finite = bool(np.isfinite(adj.data).all())
    info = {"phase": "word2vec_path", "config": vars(cfg),
            "words": len(fits[0][0].vocab), "pairs": int(len(pairs)),
            "steps": steps, "fit_s": [f for _, f in fits],
            "step_ms": [f / steps * 1e3 for _, f in fits],
            "same_bits_at_finite_lr": bits,
            "nonfinite_rows_at_defaults": nonfinite[0],
            "finite_lr": W2V_FINITE_LR,
            "nonfinite_rows_at_finite_lr": nonfinite[1],
            "kernel_b_widths": widths, "tolerance_rel": TOLERANCE,
            "build_graph_embeddings": {"build_s": build_s,
                                       "nodes": int(adj.shape[0]),
                                       "nnz": int(adj.nnz),
                                       "finite": adj_finite},
            "launches": {"fit": launches[0], "finite_lr_fit": launches[1],
                         "second_finite_lr_fit": launches[2]}}
    emit(info)
    if not bits:
        raise AssertionError("two word2vec fits gave other bits")
    for n in launches:
        if n["csr_spmm"] != 2 * steps:
            raise AssertionError(f"word2vec: {n}, {steps} steps")
    if nonfinite[1] or not adj_finite or not adj.nnz > 0 \
            or adj.shape[0] != TEXT_NODES:
        raise AssertionError(f"word2vec at lr {W2V_FINITE_LR} / "
                             f"build_graph --embeddings: {info}")
    return {"launches": info["launches"], "widths": widths}


def phase_embedding_path(root, fx, device) -> dict:
    """A tiny BERT (a ``BertConfig``: hidden 128, 2 layers, 2 heads; no
    download) over the fixture's vocabulary: ``WordEmbedder`` embeds
    every word on the card (words/s, grad mode still on after), and
    ``train.finetune`` takes a few steps and predicts. Runs only when
    ``transformers`` imports; then any error raises."""
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    try:
        import transformers  # noqa: F401
    except ImportError:
        emit({"embedding_path": "skipped: transformers not installed"})
        return {}
    import numpy as np
    import torch
    from transformers import (
        BertConfig,
        BertForSequenceClassification,
        BertModel,
        BertTokenizer,
    )

    from sgc_tpu_torch.textgraph.embedding import EmbedderConfig, WordEmbedder
    from sgc_tpu_torch.textgraph.graph import TextCorpus
    from sgc_tpu_torch.train.finetune import FinetuneConfig, finetune_pretrained

    tc = TextCorpus.from_files(fx["metadata"], fx["corpus"])
    words = sorted({w for d in tc.doc_tokens for w in d})
    model_dir = os.path.join(root, "tiny_bert")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + words))
    tok = BertTokenizer(vocab_file=os.path.join(model_dir, "vocab.txt"))
    tok.save_pretrained(model_dir)
    bcfg = BertConfig(vocab_size=len(words) + 5, hidden_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=256, max_position_embeddings=128,
                      num_labels=len(tc.label_names))
    torch.manual_seed(0)
    BertModel(bcfg).save_pretrained(model_dir)

    emb = WordEmbedder(EmbedderConfig(model_name=model_dir, backend="torch",
                                      batch_size=256), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, n_embed = counted(lambda: emb.embed_words(words))
    embed_s = time.perf_counter() - t0
    grad_on = torch.is_grad_enabled()
    vecs = np.stack([table[w] for w in words])

    label_of = {l: i for i, l in enumerate(tc.label_names)}
    texts = [" ".join(d[:64]) for d in tc.doc_tokens]
    y = np.asarray([label_of[l] for l in tc.labels])
    fcfg = FinetuneConfig(lr=5e-5, epochs=1, batch_size=32, max_length=64)
    n_train = 8 * fcfg.batch_size
    t0 = time.perf_counter()
    (predict, (model, _)), n_ft = counted(lambda: finetune_pretrained(
        texts[:n_train], y[:n_train], len(tc.label_names), fcfg,
        tokenizer=tok, model=BertForSequenceClassification(bcfg),
        device=device))
    ft_s = time.perf_counter() - t0
    held_out = texts[n_train:n_train + 256]
    t0 = time.perf_counter()
    preds = predict(held_out)
    pred_s = time.perf_counter() - t0
    info = {"phase": "embedding_path",
            "transformers": transformers.__version__,
            "words": len(words), "embed_s": embed_s,
            "words_per_s": len(words) / embed_s, "dim": int(vecs.shape[1]),
            "grad_mode_on_after": grad_on,
            "finetune": {"steps": n_train // fcfg.batch_size, "s": ft_s,
                         "eval_mode": not model.training,
                         "predict_s": pred_s, "predicted": len(held_out)},
            "launches": {"embed": n_embed, "finetune": n_ft}}
    emit(info)
    if not grad_on or not np.all(np.isfinite(vecs)):
        raise AssertionError(f"embedding path: {info}")
    if preds.shape != (len(held_out),) or not (
            0 <= preds.min() and preds.max() < len(tc.label_names)):
        raise AssertionError(f"finetune predictions {preds[:8]}")
    return info["launches"]


def phase_text_prep(root, args) -> None:
    """The host prep at the COVID-19 corpus's shape: a seeded Scopus
    export (``write_scopus_csv``) -> ``prepare_covid_dataset`` ->
    ``clean_corpus`` (nltk stopwords, min_freq 5), each timed."""
    from sgc_tpu_torch.data.covid import prepare_covid_dataset
    from sgc_tpu_torch.data.fixtures import COVID, write_scopus_csv
    from sgc_tpu_torch.textgraph.clean import clean_corpus
    from sgc_tpu_torch.textgraph.stopwords import nltk_english, NLTK_ENGLISH

    spans = {}
    t0 = time.perf_counter()
    fx = write_scopus_csv(os.path.join(root, "scopus.csv"), seed=args.seed)
    spans["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = prepare_covid_dataset(fx["path"], os.path.join(root, "prep"))
    spans["prepare_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cleaned = clean_corpus(res.corpus_path, stopword_list="nltk",
                           min_freq=5)
    spans["clean_s"] = time.perf_counter() - t0
    vocab = {w for d in cleaned for w in d.split()}
    info = {"phase": "text_prep", **spans, "rows": fx["rows"],
            "docs_kept": res.n_train + res.n_test, "train": res.n_train,
            "test": res.n_test, "labels": len(res.label_counts),
            "clean_vocab": len(vocab),
            "clean_tokens_per_doc": sum(len(d.split()) for d in cleaned)
            / len(cleaned),
            "nltk_corpus": nltk_english() is not NLTK_ENGLISH}
    emit(info)
    if (res.n_train, res.n_test) != (COVID["n_train"], COVID["n_test"]) \
            or len(res.label_counts) != fx["labels"]:
        raise AssertionError(f"text prep off the COVID split: {info}")


def phase_text_baselines(args, device, reps) -> dict:
    """The text baselines and prep on one COVID-19-shape corpus."""
    from sgc_tpu_torch.data.fixtures import COVID, write_text_corpus

    seconds, out = {}, {}
    with scratch_dir() as root:
        t0 = time.perf_counter()
        fx = write_text_corpus(root, TEXT_DATASET, seed=args.seed, **COVID)
        seconds["write"] = time.perf_counter() - t0
        phases = {
            "sequence_path": lambda: phase_sequence_path(root, fx, device,
                                                         reps),
            "word2vec_path": lambda: phase_word2vec_path(root, fx, device,
                                                         reps),
            "embedding_path": lambda: phase_embedding_path(root, fx,
                                                           device),
            "text_prep": lambda: phase_text_prep(root, args)}
        for name, run in phases.items():
            t0 = time.perf_counter()
            out[name] = run()
            seconds[name] = time.perf_counter() - t0
    emit({"phase": "text_baselines", "seconds": seconds})
    return {"launches": {"sequence_path": out["sequence_path"]["launches"],
                         "word2vec_path": out["word2vec_path"]["launches"],
                         "embedding_path": out["embedding_path"]},
            "w2v_widths": out["word2vec_path"]["widths"],
            "seq_width": out["sequence_path"]["width"]}


SHARDED_EDGE_CHUNK = 1 << 20      # edges per kernel-B launch (edge_chunk)
SHARDED_COL_CHUNK = 256           # feature columns per panel (col_chunk)
SHARDED_STEPS = 8                 # Adam steps of the sharded head
SHARDED_LR, SHARDED_WD = 0.2, 5e-6    # the reference's fit_sharded defaults
SHARDED_TRANSPORT = "gloo, through pinned host memory; 4 ranks on cuda:0"
# the forms of the 4-rank world: (name, mesh, plan, hop keywords, the
# reference file and tolerance of the gathered rows, timed); every form's
# launches are held and its rows gathered, the phase's budget times four
SHARDED_FORMS = (
    ("allgather", (4, 1), "allgather", {}, "segment", TOLERANCE, True),
    ("halo", (4, 1), "halo", {}, "segment", TOLERANCE, True),
    ("overlap", (4, 1), "overlap", {}, "segment", TOLERANCE, True),
    ("blockdense_f32", (4, 1), "blockdense", {"precision": "f32"},
     "blockdense", TOLERANCE, True),
    ("blockdense_bf16", (4, 1), "blockdense", {"precision": "bf16"},
     "blockdense", BF16_TOLERANCE, False),
    ("edge_chunk", (4, 1), "overlap", {"edge_chunk": SHARDED_EDGE_CHUNK},
     "segment", TOLERANCE, False),
    ("col_chunk", (4, 1), "halo", {"col_chunk": SHARDED_COL_CHUNK},
     "segment", TOLERANCE, False),
    ("halo_2x2", (2, 2), "halo", {}, "segment", TOLERANCE, False),
)


def sharded_host_work(root, graph, features, device, f) -> tuple:
    """The parent's part of ``sharded_path``: the plans at P = 4 (with the
    block-dense plan at the committed admission), 2 and 1 written for the
    ranks, and the two single-device references (two kernel-B hops over
    the graph, and over the operator the block-dense plan computes).
    Returns the plan's stats under the reference bench's keys."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops.spmm import spmm_segment
    from sgc_tpu_torch.parallel.bodies import (
        blockdense_operator_vals,
        write_plans,
    )
    from sgc_tpu_torch.parallel.halo import halo_stats

    t0 = time.perf_counter()
    built = write_plans(root, graph, {4: True, 2: False, 1: False},
                        n_features=f)
    pg, ho, bd = built["plans"][4]
    secs = built["seconds"][4]
    plan = {"n_parts": 4, "dense_fraction": bd.dense_fraction,
            "n_cells": bd.n_cells,
            "cells_interior_width": int(bd.cells_int.shape[1]),
            "cells_boundary_width": int(bd.cells_bnd.shape[1]),
            "cells_interior_per_part": bd.part_cells_int.tolist(),
            "cells_boundary_per_part": bd.part_cells_bnd.tolist(),
            "halo_width": ho.halo_width, "halo_stats": halo_stats(pg),
            "build_s": secs["partition_s"] + secs["halo_s"]
            + secs["blockdense_s"],
            "partition_s": secs["partition_s"], "halo_s": secs["halo_s"],
            "cells_s": secs["blockdense_s"], "write_s": secs["write_s"],
            "p2": built["seconds"][2], "p1": built["seconds"][1]}
    g = graph.to(device)
    x = torch.as_tensor(features, device=device)
    np.save(os.path.join(root, "ref_segment.npy"),
            spmm_segment(g, spmm_segment(g, x)).cpu().numpy())
    g = graph.with_vals(blockdense_operator_vals(graph, pg, ho,
                                                 bd)).to(device)
    np.save(os.path.join(root, "ref_blockdense.npy"),
            spmm_segment(g, spmm_segment(g, x)).cpu().numpy())
    plan["host_s"] = time.perf_counter() - t0
    return plan, (pg, ho, bd)


def phase_sharded_path(data, device, card, seed, reps) -> dict:
    """The sharded path on the main path's plan-order graph (F = 602, 41
    classes): host plans at P = 4 (partition, overlapped halo, block-dense
    at the committed admission), 2 and 1 (``sharded_host_work``); a world
    of 4 ranks on the card over gloo running every form of
    ``SHARDED_FORMS`` (each launch held against its plain version, the
    gathered rows against two kernel-B hops on one device),
    validate_exchange, assert_deterministic, 8 train steps on (2, 2)
    against (1, 1), measure_spmm_scaling; and an NCCL world of one rank
    against gloo, which runs while the plans are built. The counters are
    the ranks': each rank zeroes them just before a form's held run and
    reads them just after."""
    import concurrent.futures
    import shutil

    import numpy as np
    import torch

    from sgc_tpu_torch.parallel.bodies import (
        smoke_world,
        smoke_world_of_one,
        write_inputs,
    )
    from sgc_tpu_torch.parallel.distributed import launch
    from sgc_tpu_torch.utils.buildcache import clear_placed

    graph, features, labels, idx_train = data
    clear_placed()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_sharded")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    f, c = int(features.shape[1]), int(labels.max()) + 1
    bound = 1.0 / np.sqrt(f)
    state = {"w": rng.uniform(-bound, bound, (f, c)).astype(np.float32),
             "b": rng.uniform(-bound, bound, c).astype(np.float32),
             "count": 0, "mu_w": np.zeros((f, c), np.float32),
             "nu_w": np.zeros((f, c), np.float32),
             "mu_b": np.zeros(c, np.float32), "nu_b": np.zeros(c, np.float32)}
    cfg = {"degree": 2, "tolerance": TOLERANCE, "state": state,
           "steps": SHARDED_STEPS, "lr": SHARDED_LR,
           "weight_decay": SHARDED_WD, "scaling_repeats": 1,
           "reps": reps,
           "forms": [{"name": n, "mesh": list(m), "plan": pl, "kw": kw,
                      "ref": f"ref_{ref}.npy", "ref_tolerance": tol,
                      "timed": timed,
                      **({"keep": True} if n == "halo" else {}),
                      **({"same_bits_as": "halo"} if n == "col_chunk"
                         else {})}
                     for n, m, pl, kw, ref, tol, timed in SHARDED_FORMS]}
    done = False
    try:
        t0 = time.perf_counter()
        write_inputs(root, graph, features, labels, idx_train)
        inputs_s = time.perf_counter() - t0
        # both worlds start now; the 4 ranks import, join their group and
        # wait for the "ready" marker while this process builds the plans
        # and the NCCL world of one rank runs (its own P = 1 plan), so no
        # timed run shares the card with either
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            t_world, t_world_unix = time.perf_counter(), time.time()
            pending = pool.submit(launch, smoke_world, 4, "gloo",
                                  os.path.join(root, "init"), (root, cfg),
                                  420)
            pending_one = pool.submit(
                launch, smoke_world_of_one, 1, "nccl",
                os.path.join(root, "init1"), (root, cfg), 300)
            try:
                host, plans4 = sharded_host_work(root, graph, features,
                                                 device, f)
                one = pending_one.result()[0]
            except BaseException:
                # the waiting ranks see this and stop at once
                open(os.path.join(root, "abort"), "w").close()
                raise
            one_s = time.perf_counter() - t_world
            open(os.path.join(root, "ready"), "w").close()
            ranks = pending.result()
            world_s = time.perf_counter() - t_world
        # the world has ended: rank 0's operands alone on the card
        library = sharded_library_times(plans4, device, reps)
        del plans4
        done = True
    finally:
        # the plans and inputs stay for sharded_training_path
        if not done:
            shutil.rmtree(root, ignore_errors=True)
    plan = {**host, "inputs_write_s": inputs_s}

    forms, launches, worst = {}, {}, {}
    for n, *_ in SHARDED_FORMS:
        per_rank = [r["forms"][n] for r in ranks]
        errs = {}
        for rec in per_rank:
            for k, (a, r) in rec["vs_plain"].items():
                pa, pr = errs.get(k, (0.0, 0.0))
                errs[k] = (max(pa, a), max(pr, r))
                wa = worst.get(k, 0.0)
                worst[k] = max(wa, a)
        timed = per_rank[0]["hops_s"] is not None
        forms[n] = {
            "hops_s": max(rec["hops_s"] for rec in per_rank) if timed
            else None,
            "hops_s_per_rank": [rec["hops_s"] for rec in per_rank],
            "exchange_ms": max(rec["exchange_ms"] for rec in per_rank)
            if timed else None,
            "sections_s_per_rank": [rec["sections_s"] for rec in per_rank],
            "launches_per_rank": [rec["launches"] for rec in per_rank],
            "held_launches_per_rank": [rec["held_launches"]
                                       for rec in per_rank],
            "vs_plain": {k: {"max_abs_err": a, "rel_err": r}
                         for k, (a, r) in errs.items()},
            "gathered": dict(zip(("max_abs_err", "rel_err"),
                                 ranks[0]["gathered"][n])),
            "transport": SHARDED_TRANSPORT}
        if "same_bits" in per_rank[0]:
            forms[n]["same_bits_as_halo"] = all(rec["same_bits"]
                                                for rec in per_rank)
            if not forms[n]["same_bits_as_halo"]:
                raise AssertionError("col_chunk hop differs from the "
                                     "unpaneled one")
        launches[n] = {k: sum(rec["launches"][k] for rec in per_rank)
                       for k in per_rank[0]["launches"]}
        uses = ("blockdense_cells", "csr_spmm") if n.startswith(
            "blockdense") else ("csr_spmm",)
        for k in uses:
            if min(rec["launches"][k] for rec in per_rank) <= 0:
                raise AssertionError(f"sharded {n}: a rank never launched "
                                     f"{k}: {forms[n]['launches_per_rank']}")
    launches["nccl_world_of_one"] = one["nccl"]["launches"]
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "sharded_path", "nvidia_smi": card,
          "transport": SHARDED_TRANSPORT,
          "sharded_blockdense_plan": plan, "forms": forms,
          "kernels_per_rank": [r["kernels"] for r in ranks],
          "validate_exchange": {"deltas_max": ranks[0]["deltas_max"],
                                "fault": ranks[0]["fault"]},
          "train": {"mesh": [2, 2], "steps": SHARDED_STEPS,
                    "train_s": max(r["train_s"] for r in ranks),
                    **ranks[0]["train"], "transport": SHARDED_TRANSPORT},
          "nccl_world_of_one": {**one, "transport": "nccl, 1 rank"},
          "scaling": {**ranks[0]["scaling"],
                      "label": "P ranks on one card, gloo over host; not a "
                               "scaling figure"},
          "sections_s_per_rank": [r["sections_s"] for r in ranks],
          "rank_start_s": max(r["started_unix"] for r in ranks)
          - t_world_unix,
          "world_s": world_s, "world_of_one_s": one_s,
          "library_rank0": library, "phase_s": phase_s})
    log(f"sharded_path: {phase_s:.1f}s ({ranks[0]['scaling_line']}; P "
        "ranks on one card, gloo over host)")
    return {"launches": launches, "max_abs_err": worst, "root": root,
            "library": library}


def sharded_library_times(plans, device, reps) -> dict:
    """Rank 0's operands of the P = 4 block-dense plan (``plans``: the
    partition, halo and block-dense plans sharded_path writes), placed in
    this process once the world has ended, so each call has the card to
    itself: each kernel call of one forward hop at F = 602 (``"f32"``)
    and of its backward at F = 41 (the transposed cells, remainders and
    send scatter), timed beside its plain version and the same function
    as one library call: the cells' nonzeros as a CSR matrix under
    ``torch.addmm``, a remainder as one under ``torch.addmm`` with the
    dense term it adds, or ``torch.sparse.mm`` where it adds none. Each
    library result is held against the kernel's (BF16_TOLERANCE: kernel
    A at "f32" sums two bf16 terms of x)."""
    import torch

    from sgc_tpu_torch.ops import spmm_blockdense as bd_ops
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain
    from sgc_tpu_torch.parallel.autograd import (
        live_send_slots,
        transposed_view,
    )
    from sgc_tpu_torch.parallel.blockdense import local_blockdense
    from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh

    pg, _, bd = plans
    mesh = Mesh(shape={NODES_AXIS: pg.n_parts, FEAT_AXIS: 1}, rank=0,
                coords={NODES_AXIS: 0, FEAT_AXIS: 0}, groups={},
                device=device, transport=None)
    local = local_blockdense(mesh, bd)
    gen = torch.Generator(device=device).manual_seed(11)
    R, PH = bd.rows_per_part, bd.n_parts * bd.halo_width

    def randn(n, f):
        return torch.randn((n, f), device=device, generator=gen)

    def a_term(split, args, x):
        csr = cells_csr(split, args, split.n_cells)
        zero = x.new_zeros((split.n_rows, x.shape[1]))
        got = bd_ops.apply_cells(split, args, x, "f32")
        _, err = rel_err(torch.addmm(zero, csr, x, beta=0.0), got)
        if not err <= BF16_TOLERANCE:
            raise AssertionError(f"cells as CSR vs kernel A: {err:.3e}")
        return got, {
            "F": int(x.shape[1]), "cells": split.n_cells,
            "ms": time_ms(lambda: bd_ops.apply_cells(split, args, x, "f32"),
                          reps),
            "plain_ms": time_ms(
                lambda: bd_ops.apply_cells_plain(split, args, x, "f32"), 2),
            "library_ms": time_ms(
                lambda: torch.addmm(zero, csr, x, beta=0.0), reps),
            "library": f"torch.addmm, {int(csr._nnz())} cell nonzeros as "
                       "CSR", "library_rel_err": err}

    def b_term(graph, x, dense):
        csr = csr_of(graph)
        lib = ((lambda: torch.sparse.mm(csr, x)) if dense is None
               else (lambda: torch.addmm(dense, csr, x)))
        _, err = rel_err(lib(), spmm_segment(graph, x, dense))
        if not err <= TOLERANCE:
            raise AssertionError(f"remainder as CSR vs kernel B: {err:.3e}")
        return {"F": int(x.shape[1]), "nnz": graph.nnz,
                "ms": time_ms(lambda: spmm_segment(graph, x, dense), reps),
                "plain_ms": time_ms(
                    lambda: spmm_segment_plain(graph, x, dense), 2),
                "library_ms": time_ms(lib, reps),
                "library": ("torch.sparse.mm" if dense is None else
                            "torch.addmm with the dense term") + ", CSR",
                "library_rel_err": err}

    out = {"rank": 0, "a": {}, "b": {}}
    x, halo = randn(R, 602), randn(PH, 602)
    for side, split, args, xs, rest in (
            ("interior", local.split_int, local.args_int, x, local.rest_int),
            ("boundary", local.split_bnd, local.args_bnd, halo,
             local.rest_bnd)):
        dense = None
        if split is not None:
            dense, out["a"][side] = a_term(split, args, xs)
        out["b"][side] = b_term(rest.graph, xs, dense)
    t = transposed_view("blockdense", local, device,
                        live_send_slots(pg, bd.halo_width, 0))
    g, g_halo = randn(R, 41), randn(PH, 41)
    for side, cells in (("interior", t.cells_int), ("boundary", t.cells_bnd)):
        if cells is not None:
            out["a"][f"backward_{side}"] = a_term(*cells, g)[1]
    for name, csr, xs in (("backward_interior", t.interior, g),
                          ("backward_boundary", t.boundary, g),
                          ("backward_send_scatter", t.scatter, g_halo)):
        out["b"][name] = b_term(csr.graph, xs, None)
    del local, t
    torch.cuda.empty_cache()
    return out


TRAINING_EPOCHS = 20              # Adam epochs of the sharded SGC fit
TRAINING_SAVE_EVERY = 10          # checkpoint period (the resumed half)
TRAINING_LR, TRAINING_WD = 0.2, 5e-6  # fit_sharded's defaults
TRAINING_ONE_EPOCHS = 5           # the NCCL world of one's fit
GCN_SMOKE = {"hidden": 16, "epochs": 5, "bd_steps": 3, "lr": 0.01,
             "weight_decay": 5e-4, "precision": "bf16"}
SHARD_STORE_BATCHES, SHARD_STORE_BATCH = 8, 1024
TRAINING_CLI_REDDIT_SCALE = 0.1   # the cli.reddit fixture's fraction
TRAINING_TRANSPORT = ("gloo, through pinned host memory; 4 ranks on "
                      "cuda:0")


def gcn_init(f, hidden, c, seed) -> dict:
    """A two-layer GCN's parameters drawn with numpy from ``seed``, each
    layer U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as ``models/gcn.py``."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {"w1": u((f, hidden), f), "b1": u(hidden, f),
            "w2": u((hidden, c), hidden), "b2": u(c, hidden)}


def gcn_single_device(graph, features, labels, idx_train, init, device):
    """The single-device GCN (``train/loops.py``'s Adam epochs, no
    dropout) from ``init``: the loss of every epoch before its update."""
    from types import SimpleNamespace

    import torch

    from sgc_tpu_torch.models.gcn import gcn_apply, params_from_jax
    from sgc_tpu_torch.train.loops import (
        _adam_steps,
        node_cross_entropy,
        train_target,
    )

    g = GCN_SMOKE
    model = params_from_jax(SimpleNamespace(**init), device=device)
    x = torch.as_tensor(features, device=device)
    gd = graph.to(device)
    lab, weights = train_target(graph.n_rows, idx_train, torch.as_tensor(
        labels[idx_train], device=device))
    losses = torch.zeros(g["epochs"], device=device)
    _adam_steps([{"params": list(model.parameters()),
                  "weight_decay": g["weight_decay"]}], g["lr"],
                lambda: node_cross_entropy(gcn_apply(model, x, gd), lab,
                                           weights), g["epochs"], losses)
    return losses.cpu().tolist()


def training_host_work(root, data, device) -> dict:
    """The parent's part of ``sharded_training_path``: the (2, 2) fit plan
    (``plan_fit``, block-dense at a rank's feature width), the train
    graph (the train rows' and columns' block of the operator) with its
    P = 4 partition, halo and block-dense plans, the single-device
    references of the dual propagation (two kernel-B hops over the train
    graph, and over the operator its block-dense plan computes)."""
    import numpy as np
    import torch

    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm import spmm_segment
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense
    from sgc_tpu_torch.parallel.bodies import blockdense_operator_vals
    from sgc_tpu_torch.parallel.distributed import save_host
    from sgc_tpu_torch.parallel.fit import plan_fit, save_fit_plan
    from sgc_tpu_torch.parallel.halo import build_halo
    from sgc_tpu_torch.parallel.partition import partition_graph

    graph, features, _, idx_train = data
    f = int(features.shape[1])
    secs = {}
    t0 = time.perf_counter()
    plan = plan_fit(graph, 2, 2, f)
    save_fit_plan(os.path.join(root, "fit22"), plan)
    secs["fit22_plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = np.asarray(idx_train)
    sub = graph.to_scipy().tocsr()[idx][:, idx]
    tg = SparseGraph.from_scipy(sub)
    pt = partition_graph(tg, 4, device=False)
    ht = build_halo(pt, device=False)
    bdt = build_sharded_blockdense(pt, ht, f, device=False)
    for name, obj in (("pgraph", pt), ("halo", ht), ("bd", bdt)):
        save_host(os.path.join(root, "train4", name), obj)
    secs["train_plans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xt = torch.as_tensor(np.asarray(features)[idx], device=device)
    for name, g in (("segment", tg), ("blockdense", tg.with_vals(
            blockdense_operator_vals(tg, pt, ht, bdt)))):
        gd = g.to(device)
        np.save(os.path.join(root, f"ref_train_{name}.npy"),
                spmm_segment(gd, spmm_segment(gd, xt)).cpu().numpy())
    secs["references_s"] = time.perf_counter() - t0
    return {"seconds": secs,
            "fit22": {"formulation": plan.formulation,
                      "halo_fraction": plan.halo_fraction,
                      "dense_fraction": plan.dense_fraction},
            "train_graph": {"nodes": tg.n_rows, "nnz": tg.nnz,
                            "cells": bdt.n_cells,
                            "dense_fraction": bdt.dense_fraction}}


def shard_store_check(root, device, seed) -> dict:
    """InferenceEngine(shard_store=True), f32 and int8, over the
    propagated store (S^2 X of the sharded path): every card of the
    process holds a shard (one here); 8 batches of 1,024 random ids,
    bit for bit the unsharded engine's logits."""
    import numpy as np
    import torch

    from sgc_tpu_torch.models.sgc import SGC
    from sgc_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    feats = np.load(os.path.join(root, "ref_segment.npy"))
    rng = np.random.default_rng(seed)
    n, f = feats.shape
    head = SGC(torch.tensor(rng.standard_normal((f, 41)).astype(np.float32)
                            / np.sqrt(f), device=device),
               torch.zeros(41, device=device))
    out = {}
    for name, q in (("f32", False), ("int8", True)):
        t0 = time.perf_counter()
        cfg = dict(max_batch=SHARD_STORE_BATCH, quantize_int8=q)
        plain = InferenceEngine(head, features=feats, device=device,
                                config=EngineConfig(**cfg))
        sharded = InferenceEngine(head, features=feats, device=device,
                                  config=EngineConfig(shard_store=True,
                                                      **cfg))
        equal = True
        for _ in range(SHARD_STORE_BATCHES):
            ids = rng.integers(0, n, SHARD_STORE_BATCH)
            equal &= bool(np.array_equal(sharded.predict_logits(ids),
                                         plain.predict_logits(ids)))
        out[name] = {"shards": len(sharded._shards), "same_bits": equal,
                     "seconds": time.perf_counter() - t0}
        if not equal:
            raise AssertionError(f"shard_store {name} differs from the "
                                 "unsharded engine")
        del plain, sharded
    return out


TRAINING_CLIS = ("reddit_sharded_inductive", "citation_sharded_sgc",
                 "citation_sharded_gcn", "scaling", "dist_demo")


def start_training_clis(root, seed, pool) -> tuple:
    """Write the entry points' fixtures (a Reddit pair at
    ``TRAINING_CLI_REDDIT_SCALE``, a Pubmed-shape set) and start the
    entry points as processes on the card in ``pool`` (each launches its
    own world: one NCCL rank for cli.reddit and cli.citation, gloo ranks
    on the card for cli.scaling --ranks 4 and cli.dist_demo). Returns
    ``(fixtures, {name: future of (completed process, seconds)})``."""
    from sgc_tpu_torch.data.fixtures import (
        PUBMED,
        write_planetoid,
        write_reddit,
    )

    rd, pm = os.path.join(root, "cli_rd"), os.path.join(root, "cli_pm")
    pubmed = write_planetoid(pm, "pubmed", seed=seed, **PUBMED)
    fixtures = {"reddit": write_reddit(rd, scale=TRAINING_CLI_REDDIT_SCALE,
                                       seed=seed),
                "pubmed": {k: pubmed[k] for k in ("n_nodes", "n_edges",
                                                  "n_allx")}}
    py = [sys.executable, "-m"]
    cmds = {
        "reddit_sharded_inductive": py + [
            "sgc_tpu_torch.cli.reddit", "--sharded", "--inductive",
            "--test", "--data_path", rd],
        "citation_sharded_sgc": py + [
            "sgc_tpu_torch.cli.citation", "--dataset", "pubmed",
            "--sharded", "--data_path", pm],
        "citation_sharded_gcn": py + [
            "sgc_tpu_torch.cli.citation", "--dataset", "pubmed",
            "--model", "GCN", "--lr", "0.01", "--sharded",
            "--data_path", pm],
        "scaling": py + ["sgc_tpu_torch.cli.scaling", "--ranks", "4",
                         "--transport", "gloo", "--repeats", "1",
                         "--json"],
        "dist_demo": py + ["sgc_tpu_torch.cli.dist_demo", "--procs", "2",
                           "--devices-per-proc", "2"],
    }
    env = {**os.environ,
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}

    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=600)
        return p, time.perf_counter() - t0

    return fixtures, {k: pool.submit(run, cmds[k]) for k in TRAINING_CLIS}


def finish_training_clis(fixtures, pending) -> dict:
    """Wait for the entry points: every one exits 0; cli.reddit's
    micro-F1 above 5x chance, cli.citation's test accuracies above 1.5x
    chance, cli.dist_demo's parity ``ok``; their result lines."""
    from sgc_tpu_torch.data.fixtures import PUBMED

    out = {}
    for k, fut in pending.items():
        p, secs = fut.result()
        out[k] = {"rc": p.returncode, "seconds": secs,
                  "lines": p.stdout.strip().splitlines()}
        if p.returncode != 0:
            raise AssertionError(f"{k} exited {p.returncode}:\n"
                                 f"{p.stderr[-3000:]}")
    for k in ("scaling", "dist_demo"):
        out[k]["json"] = [json.loads(line) for line in out[k]["lines"]
                          if line.startswith("{")]
    if not out["dist_demo"]["json"][-1]["ok"]:
        raise AssertionError(f"dist_demo: {out['dist_demo']['json']}")
    f1 = float(out["reddit_sharded_inductive"]["lines"][-2].rsplit(
        " ", 1)[1])
    chance = 1.0 / fixtures["reddit"]["classes"]
    if not f1 > 5 * chance:
        raise AssertionError(f"cli.reddit --sharded micro-F1 {f1}")
    for k in ("citation_sharded_sgc", "citation_sharded_gcn"):
        acc = float(out[k]["lines"][-2].rsplit(" ", 1)[1])
        if not acc > 1.5 / PUBMED["n_classes"]:
            raise AssertionError(f"{k}: test accuracy {acc}")
    out["fixtures"] = fixtures
    return out


def phase_sharded_training_path(data, root, device, card, seed,
                                reps) -> dict:
    """Distributed training and its entry points on the main path's
    plan-order graph (F = 602, 41 classes), on ``sharded_path``'s plans
    and inputs under ``root`` (removed at the end): the 4-rank gloo world
    of ``bodies.smoke_training_world`` (started at once; it waits while
    this process builds the (2, 2) fit plan, the train graph's plans and
    the references), the NCCL world of one of
    ``bodies.smoke_training_world_of_one`` beside it, then the sharded
    serving store and the entry points as processes. Each rank zeroes
    its counters just before a part and reads them just after; the parts
    of the ranks' own worlds count their launches, the entry points'
    worlds are processes of their own and report their results."""
    import concurrent.futures
    import shutil

    import numpy as np

    from sgc_tpu_torch.parallel.bodies import (
        smoke_training_world,
        smoke_training_world_of_one,
    )
    from sgc_tpu_torch.parallel.distributed import launch

    t_phase = time.perf_counter()
    cfg = {"degree": 2, "epochs": TRAINING_EPOCHS,
           "save_every": TRAINING_SAVE_EVERY, "lr": TRAINING_LR,
           "weight_decay": TRAINING_WD, "seed": seed,
           "one_epochs": TRAINING_ONE_EPOCHS, "tolerance": TOLERANCE,
           "bf16_tolerance": BF16_TOLERANCE, "reps": reps}
    init = gcn_init(int(data[1].shape[1]), GCN_SMOKE["hidden"],
                    int(data[2].max()) + 1, seed)
    cfg["gcn"] = {**GCN_SMOKE, "init": init}
    try:
        with concurrent.futures.ThreadPoolExecutor(
                2 + len(TRAINING_CLIS)) as pool:
            # the entry points, both worlds, then this process's host
            # work run at once; the 4 ranks wait for the marker while this
            # process builds the plans and references
            t0 = time.perf_counter()
            fixtures, clis_pending = start_training_clis(root, seed, pool)
            fixtures_s = time.perf_counter() - t0
            t_world, t_world_unix = time.perf_counter(), time.time()
            world = pool.submit(launch, smoke_training_world, 4, "gloo",
                                os.path.join(root, "init_t4"), (root, cfg),
                                420)
            pending_one = pool.submit(
                launch, smoke_training_world_of_one, 1, "nccl",
                os.path.join(root, "init_t1"), (root, cfg), 300)
            try:
                host = training_host_work(root, data, device)
                open(os.path.join(root, "ready_training"), "w").close()
            except BaseException:
                open(os.path.join(root, "abort"), "w").close()
                raise
            ready_s = time.perf_counter() - t_world
            t0 = time.perf_counter()
            host["gcn_single"] = gcn_single_device(*data, init, device)
            host["seconds"]["gcn_single_device_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            store = shard_store_check(root, device, seed)
            store_s = time.perf_counter() - t0
            ranks = world.result()
            world_s = time.perf_counter() - t_world
            one = pending_one.result()[0]
            clis = finish_training_clis(fixtures, clis_pending)
            clis["fixtures_s"] = fixtures_s
            clis_s = time.perf_counter() - t_world
    finally:
        shutil.rmtree(root, ignore_errors=True)

    parts, launches = {}, {}
    for name in ranks[0]["parts"]:
        per_rank = [r["parts"][name] for r in ranks]
        parts[name] = {
            "seconds": max(p["seconds"] for p in per_rank),
            "launches_per_rank": [p["launches"] for p in per_rank],
            **{k: v for k, v in per_rank[0].items()
               if k not in ("seconds", "launches")}}
        launches[name] = {k: sum(p["launches"][k] for p in per_rank)
                          for k in per_rank[0]["launches"]}
        uses = ["csr_spmm"]
        if "blockdense" in name or name.startswith(("fit_", "staged")):
            uses.append("blockdense_cells")
        if name == "gcn_blockdense":
            uses += ["blockdense_cells_backward", "csr_spmm_backward"]
        for k in uses:
            if min(p["launches"][k] for p in per_rank) <= 0:
                raise AssertionError(f"{name}: a rank never launched {k}: "
                                     f"{parts[name]['launches_per_rank']}")
    launches["nccl_world_of_one"] = one["nccl"]["launches"]
    sharded = np.asarray(parts["gcn_halo"]["losses"])
    single = np.asarray(host["gcn_single"])
    gcn_err = float(np.max(np.abs(sharded - single) / np.abs(single)))
    if not np.allclose(sharded, single, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"sharded GCN losses {sharded} vs single "
                             f"device {single}")
    worst = {"blockdense_cells": 0.0, "csr_spmm": 0.0}
    for r in ranks:
        held = r["parts"]["gcn_blockdense"]["held"]
        for direction in ("forward", "backward"):
            for k, (a, _) in held[direction].items():
                worst[k] = max(worst[k], a)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "sharded_training_path", "nvidia_smi": card,
          "transport": TRAINING_TRANSPORT, "host": {
              k: host[k] for k in ("seconds", "fit22", "train_graph")},
          "parts": parts,
          "gcn_vs_single_device": {"losses": host["gcn_single"],
                                   "max_rel_err": gcn_err},
          "held_max_abs_err": worst,
          "backward_kernels_per_rank": [r["backward_kernels"]
                                        for r in ranks],
          "nccl_world_of_one": {**one, "transport": "nccl, 1 rank"},
          "shard_store": {**store, "seconds": store_s},
          "clis": {**clis, "seconds_from_world_start": clis_s},
          "sections_s_per_rank": [r["sections_s"] for r in ranks],
          "rank_start_s": max(r["started_unix"] for r in ranks)
          - t_world_unix, "ready_s": ready_s, "world_s": world_s,
          "phase_s": phase_s})
    log(f"sharded_training_path: {phase_s:.1f}s (4 ranks on one card, gloo "
        "over host)")
    return {"launches": launches, "max_abs_err": worst,
            "backward": [r["backward_kernels"] for r in ranks]}


ORDERINGS_ON_REDDIT = ("rcm", "bfs", "degree", "none")


def rows_by_old_id(plan, tr):
    """A plan's train rows (``(S^K X)[idx_train]`` in its own numbering)
    in the loader's numbering, ascending node id."""
    import numpy as np
    import torch

    old = plan.order[plan.idx_train]
    return tr[torch.as_tensor(np.argsort(old, kind="stable"),
                              device=tr.device)]


def held_hop(split, args, x, hop) -> tuple:
    """One block-dense hop as the plan runs it, kernel A's dense term and
    kernel B's remainder each held against its plain version on the same
    inputs at ``TOLERANCE``: (the hop's output, the dense term, the
    record)."""
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    rec, dense, out = {}, None, None
    if split.n_cells:
        dense = bd.apply_cells(split, args, x, "f32")
        rec["kernel_a_" + hop] = rel_err(
            dense, bd.apply_cells_plain(split, args, x, "f32"))
        out = dense
    if args.rest is not None:
        out = spmm_segment(args.rest, x, dense)
        rec["kernel_b_" + hop] = rel_err(
            out, spmm_segment_plain(args.rest, x, dense))
    for name, (_, err) in rec.items():
        if not err <= TOLERANCE:
            raise AssertionError(f"{name} vs plain: {err:.3e}")
    return out, dense, rec


def ordering_run(data, name, device, reps) -> dict:
    """``LocalityPlan.build(ordering=name)`` and its two hops, each kernel
    launch of the hops held against its plain version on the hop's own
    inputs (the terms recomputed give the plan's rows bit for bit), the
    plan's train rows in the loader's numbering, and its kernels timed
    on the plan's main split."""
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment
    from sgc_tpu_torch.utils.profiling import sync

    def build_and_hop():
        t0 = time.perf_counter()
        plan = LocalityPlan.build(*data, ordering=name, formulation="auto",
                                  device=device)
        prep_s = time.perf_counter() - t0
        khop, dargs = plan.khop_traceable(degree=2, precision="f32")
        x = torch.as_tensor(plan.features, device=device)
        khop(x, dargs)
        sync(device)
        t0 = time.perf_counter()
        tr = khop(x, dargs)
        sync(device)
        return plan, x, tr, prep_s, time.perf_counter() - t0

    (plan, x, tr, prep_s, hops_s), launches = counted(build_and_hop)
    # (the plain form on the CPU, where the phases are rehearsed)
    if plan.formulation != ("blockdense_kernel" if device.type == "cuda"
                            else "blockdense"):
        raise AssertionError(f"ordering {name}: formulation "
                             f"{plan.formulation}, not kernels A and B")
    s, args = plan.split_main, plan._device_args()[0]
    h1, dense, held = held_hop(s, args, x, "main")
    out, _, rec = held_hop(plan.split_final, plan._device_args()[1], h1,
                           "final")
    held.update(rec)
    if not torch.equal(out, tr):
        raise AssertionError(f"ordering {name}: the held hops differ from "
                             "the plan's rows")
    del h1, out
    a_ms = (time_ms(lambda: bd.apply_cells(s, args, x, "f32"), reps)
            if s.n_cells else None)
    b_ms = (time_ms(lambda: spmm_segment(args.rest, x, dense), reps)
            if args.rest is not None else None)
    edges = plan.graph.nnz + plan.graph_final.nnz
    info = {"ordering": name, "formulation": plan.formulation,
            "order_s": plan.prep_seconds["order_s"], "prep_s": prep_s,
            "prep_stages": plan.prep_seconds,
            "dense_frac": plan.dense_fraction, "cells_main": s.n_cells,
            "cells_final": plan.split_final.n_cells,
            "remainder_nnz_main": s.sparse_edges,
            "remainder_nnz_final": plan.split_final.sparse_edges,
            "hops_s": hops_s, "edges_per_s": edges / hops_s,
            "kernel_a_f32_ms": a_ms, "kernel_b_remainder_ms": b_ms,
            "vs_plain": {k: {"max_abs_err": a, "rel_err": r}
                         for k, (a, r) in held.items()},
            "vs_plain_tolerance_rel": TOLERANCE, "launches": launches}
    rows = rows_by_old_id(plan, tr)
    no_cells = s.n_cells == 0 and plan.split_final.n_cells == 0
    return {"info": info, "rows": rows, "no_cells": no_cells,
            "launches": launches, "order": plan.order,
            "max_abs_err": {k: max((a for n, (a, _) in held.items()
                                    if n.startswith(prefix)), default=0.0)
                            for k, prefix in (("blockdense_cells",
                                               "kernel_a"),
                                              ("csr_spmm", "kernel_b"))}}


def phase_ordering_path(data, lpa_rows, device, reps) -> dict:
    """``LocalityPlan.build(ordering=...)`` for rcm, bfs, degree and none
    on the main path's shuffled Reddit-shape graph (F = 602, 512 x 512
    cells), two hops each through kernels A and B, each launch of the
    hops held against its plain version at ``TOLERANCE`` (``held_hop``);
    every plan's rows, in the loader's numbering, held against the LPA
    plan's and against two hops of kernel B over the whole graph, both
    at ``BF16_TOLERANCE`` (bf16 cells; ``TOLERANCE`` where a plan admits
    no cell); then ``spectral`` on a Cora-shape fixture (2,708 nodes;
    both packages' shift-invert ``eigsh`` took 243 s on the card's host
    for the Pubmed shape's random graph, and would factorize 11.6M
    nonzeros for the Reddit shape), its largest component's eigensolve
    shown converged and its order unlike RCM's."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from sgc_tpu_torch.data.fixtures import CORA, write_planetoid
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.graph.reorder import rcm_order
    from sgc_tpu_torch.ops.spmm import spmm_segment
    from sgc_tpu_torch.utils.buildcache import clear_placed

    t_phase = time.perf_counter()
    graph, features, _, idx_train = data
    g = graph.to(device)
    x0 = torch.as_tensor(features, device=device)
    # two hops of kernel B over the whole graph, in the loader's numbering
    kernel_b_rows = spmm_segment(g, spmm_segment(g, x0))[
        torch.as_tensor(np.sort(idx_train), device=device)]
    del g, x0
    runs, launches = {}, {}
    max_abs = {"blockdense_cells": 0.0, "csr_spmm": 0.0}
    for name in ORDERINGS_ON_REDDIT:
        r = ordering_run(data, name, device, reps)
        tol = TOLERANCE if r["no_cells"] else BF16_TOLERANCE
        _, err_lpa = rel_err(r["rows"], lpa_rows)
        if not err_lpa <= BF16_TOLERANCE:
            raise AssertionError(f"ordering {name} vs the LPA plan: "
                                 f"{err_lpa:.3e}")
        _, err_b = rel_err(r["rows"], kernel_b_rows)
        if not err_b <= tol:
            raise AssertionError(f"ordering {name} vs kernel B's hops: "
                                 f"{err_b:.3e}")
        if r["launches"]["csr_spmm"] <= 0:
            raise AssertionError(f"ordering {name} never launched kernel B")
        runs[name] = {**r["info"], "rows_vs_lpa_rel_err": err_lpa,
                      "rows_vs_kernel_b_rel_err": err_b,
                      "tolerance_rel": tol}
        launches[name] = r["launches"]
        max_abs = {k: max(v, r["max_abs_err"][k]) for k, v in max_abs.items()}
        del r
        clear_placed()
        torch.cuda.empty_cache()
    if sum(n["blockdense_cells"] for n in launches.values()) <= 0:
        raise AssertionError("no ordering's plan launched kernel A")

    # spectral on the Cora-shape fixture, eigsh's calls recorded
    calls = []
    eigsh = spla.eigsh

    def recorded(a, *pos, **kw):
        try:
            out = eigsh(a, *pos, **kw)
        except Exception:
            calls.append((a.shape[0], False))
            raise
        calls.append((a.shape[0], True))
        return out

    with scratch_dir() as root:
        write_planetoid(root, "cora", **CORA, seed=42)
        cora = load_citation("cora", data_path=root, device="cpu")
    cora_data = (cora.graph, cora.features.numpy(), cora.labels.numpy(),
                 cora.idx_train)
    spla.eigsh = recorded
    try:
        r = ordering_run(cora_data, "spectral", device, reps)
    finally:
        spla.eigsh = eigsh
    rcm = rcm_order(cora.graph.to_scipy().tocsr())
    largest = max(calls, default=(0, False))
    if not largest[1]:
        raise AssertionError(f"spectral: the largest component's eigsh "
                             f"failed ({largest[0]} nodes)")
    if np.array_equal(r["order"], rcm):
        raise AssertionError("spectral order equals RCM's")
    gp = cora.graph.to(device)
    xp = cora.features.to(device)
    kernel_b_cora = spmm_segment(gp, spmm_segment(gp, xp))[
        torch.as_tensor(np.sort(cora.idx_train), device=device)]
    _, err = rel_err(r["rows"], kernel_b_cora)
    tol = TOLERANCE if r["no_cells"] else BF16_TOLERANCE
    if not err <= tol:
        raise AssertionError(f"spectral plan vs kernel B's hops: {err:.3e}")
    max_abs = {k: max(v, r["max_abs_err"][k]) for k, v in max_abs.items()}
    runs["spectral_cora"] = {
        **r["info"], "rows_vs_kernel_b_rel_err": err, "tolerance_rel": tol,
        "eigsh_calls": len(calls),
        "eigsh_failed": sum(1 for _, ok in calls if not ok),
        "largest_component": largest[0]}
    launches["spectral_cora"] = r["launches"]
    del r, gp, xp
    clear_placed()
    emit({"phase": "ordering_path", "runs": runs,
          "wall_s": time.perf_counter() - t_phase})
    return {"launches": launches, "max_abs_err": max_abs}


def phase_prep_attribution(data, main, device) -> None:
    """Where the main path's ``prep_s`` goes: the same LPA plan build,
    twice more after the main path's timed one (so that span stays
    uninstrumented), first under ``stack_sampler(0.05)`` (its top 10
    host leaves), then bare; the two warm builds' difference is what the
    sampler costs. Then one block-dense hop under ``device_trace``."""
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.utils.profiling import stack_sampler

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    with stack_sampler(0.05) as sampler:
        plan = LocalityPlan.build(*data, formulation="auto", device=device)
    sampled_s = time.perf_counter() - t0
    stages_sampled = plan.prep_seconds
    del plan
    t0 = time.perf_counter()
    plan = LocalityPlan.build(*data, formulation="auto", device=device)
    bare_s = time.perf_counter() - t0
    stages_bare = plan.prep_seconds
    del plan
    emit({"phase": "prep_attribution", "prep_s": main["prep_s"],
          "prep_stages": main["plan"].prep_seconds,
          "warm_sampled_prep_s": sampled_s,
          "warm_sampled_prep_stages": stages_sampled,
          "warm_bare_prep_s": bare_s, "warm_bare_prep_stages": stages_bare,
          "sampler_cost_s": sampled_s - bare_s,
          "host_samples": {"interval_s": sampler.interval,
                           "samples": len(sampler.samples),
                           "top_leaves": sampler.report(10)},
          "hop": phase_prep_trace(main["plan"], main["x"]),
          "wall_s": time.perf_counter() - t_phase})


def phase_prep_trace(plan, x) -> dict:
    """One block-dense hop of the main plan (kernels A and B) under
    ``device_trace``: the top 5 device ops by self device time."""
    from sgc_tpu_torch.utils.profiling import device_trace

    full, _ = plan.hop_fns("f32")
    full(x)
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "traces", "prep_attribution")
    with device_trace(log_dir) as prof:
        full(x)

    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = sorted(prof.key_averages(), key=self_us, reverse=True)
    top = [{"op": e.key, "self_device_us": self_us(e), "count": e.count}
           for e in events[:5] if self_us(e) > 0]
    if not top:
        raise AssertionError("device_trace recorded no device time")
    return {"trace": os.path.join(log_dir, "trace.json"),
            "top_device_ops": top}


def phase_roofline(plan, rows) -> None:
    """``roofline_report`` for the main split at F = 602 from kernel A's
    "f32" and kernel B's remainder times, its bytes held equal to the
    kernels line's counts and its HBM shares to bound / time."""
    from sgc_tpu_torch.ops.roofline import roofline_report

    a, b = rows[0], rows[1]
    rep = roofline_report(plan.split_main, 602, dense_s=a["ms"] / 1e3,
                          rest_s=b["ms"] / 1e3)
    if rep["dense"]["bytes"] != a["bytes"]:
        raise AssertionError(f"roofline dense bytes {rep['dense']['bytes']}"
                             f" != kernel A's {a['bytes']}")
    if rep["remainder"]["bytes"] != b["bytes"]:
        raise AssertionError("roofline remainder bytes "
                             f"{rep['remainder']['bytes']} != kernel B's "
                             f"{b['bytes']}")
    for term, row in (("dense", a), ("remainder", b)):
        if row["bound_by"] != "bytes":
            continue
        if abs(rep[term]["hbm_frac"] - row["bound_ms"] / row["ms"]) > 5e-4:
            raise AssertionError(f"roofline {term} hbm_frac "
                                 f"{rep[term]['hbm_frac']} != bound / ms")
    emit({"phase": "roofline", "report": rep,
          "kernel_a_bound_over_ms": a["bound_ms"] / a["ms"],
          "kernel_b_bound_over_ms": b["bound_ms"] / b["ms"]})


GRAPH_STORE_MEMBERS = 8


def phase_graph_store(device, reps) -> dict:
    """Eight Pubmed-shape graphs (the Planetoid fixture at seeds 42-49)
    batched by ``block_diag``: one kernel-B product at F = 500 over the
    batch, each block equal bit for bit to its member's own product, held
    against the plain version; then ``save_graph`` / ``load_graph`` of the
    batch, the same arrays and the same product bits."""
    import numpy as np
    import torch

    from sgc_tpu_torch.data.fixtures import PUBMED, write_planetoid
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.graph.sparse import block_diag, host, load_graph, \
        save_graph
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    t_phase = time.perf_counter()
    members = []
    with scratch_dir() as root:
        for k in range(GRAPH_STORE_MEMBERS):
            d = os.path.join(root, str(k))
            write_planetoid(d, "pubmed", **PUBMED, seed=42 + k)
            members.append(load_citation("pubmed", data_path=d,
                                         device="cpu"))
        fixtures_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        batch, offsets = block_diag([m.graph for m in members])
        block_diag_s = time.perf_counter() - t0
        gb = batch.to(device)
        xb = torch.cat([m.features for m in members]).to(device)
        out, launches = counted(lambda: {"batch": spmm_segment(gb, xb)})
        out = out["batch"]
        _, err = rel_err(out, spmm_segment_plain(gb, xb))
        if not err <= TOLERANCE:
            raise AssertionError(f"block_diag product vs plain: {err:.3e}")
        for k, m in enumerate(members):
            own = spmm_segment(m.graph.to(device), m.features.to(device))
            if not torch.equal(out[offsets[k]:offsets[k + 1]], own):
                raise AssertionError(f"block {k} differs from its member's "
                                     "own product")
        ms = time_ms(lambda: spmm_segment(gb, xb), reps)
        path = os.path.join(root, "batch")
        t0 = time.perf_counter()
        save_graph(path, batch)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path + ".npz")
        t0 = time.perf_counter()
        loaded = load_graph(path)
        load_s = time.perf_counter() - t0
    for f in ("rows", "cols", "vals", "row_ptr"):
        if not np.array_equal(host(getattr(loaded, f)),
                              host(getattr(batch, f))):
            raise AssertionError(f"load_graph: {f} differs")
    if (loaded.shape, loaded.nnz) != (batch.shape, batch.nnz):
        raise AssertionError("load_graph: shape or nnz differs")
    if not torch.equal(spmm_segment(loaded.to(device), xb), out):
        raise AssertionError("the loaded batch's product differs")
    if launches["csr_spmm"] <= 0:
        raise AssertionError("graph_store never launched kernel B")
    emit({"phase": "graph_store", "members": GRAPH_STORE_MEMBERS,
          "nodes": batch.n_rows, "nnz": batch.nnz, "F": int(xb.shape[1]),
          "fixtures_s": fixtures_s, "block_diag_s": block_diag_s,
          "kernel_b_ms": ms, "rel_err": err, "tolerance_rel": TOLERANCE,
          "save_s": save_s, "load_s": load_s, "file_bytes": file_bytes,
          "launches": launches, "wall_s": time.perf_counter() - t_phase})
    return {"batch": launches}


KERNEL_BENCH_RUNS = {
    "clustered_blockdense_flat": ["--scale", "1.0", "--clustered",
                                  "--blockdense", "--flat", "--json"],
    "stripes_bf16": ["--scale", "0.1", "--precision", "bf16", "--json"],
}


def phase_kernel_bench_cli() -> dict:
    """``cli.pallas_bench.main`` in this process, twice: the clustered
    graph at full scale through the flat entry with the block-dense
    split, and the uniform graph at 0.1 through the stripe entry at
    "bf16"; errors against kernel B within TOLERANCE (kernel C at "f32")
    or BF16_TOLERANCE, kernels A + B against the plain block-dense
    version on the same split within TOLERANCE, no ``*_error`` key."""
    import io

    from sgc_tpu_torch.cli import pallas_bench

    t_phase = time.perf_counter()
    lines, launches = {}, {}
    for name, argv in KERNEL_BENCH_RUNS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, launches[name] = counted(lambda: pallas_bench.main(argv))
        if rc != 0:
            raise AssertionError(f"pallas_bench {name} exited {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        errors = [k for k in line if k.endswith("_error")]
        if errors:
            raise AssertionError(f"pallas_bench {name}: {errors}")
        f32 = "--precision" not in argv
        checks = {"rel_err_vs_xla": TOLERANCE if f32 else BF16_TOLERANCE}
        if "--blockdense" in argv:
            # kernels A + B against the plain version on the same split
            checks.update(blockdense_rel_err_vs_xla=BF16_TOLERANCE,
                          blockdense_pallas_rel_err=BF16_TOLERANCE,
                          blockdense_pallas_vs_plain_rel_err=TOLERANCE)
        for key, tol in checks.items():
            if not line[key] <= tol:
                raise AssertionError(f"pallas_bench {name}: {key} "
                                     f"{line[key]:.3e} > {tol}")
        need = ["tiled_spmm", "csr_spmm"] + (
            ["blockdense_cells"] if "--blockdense" in argv else [])
        if min(launches[name][k] for k in need) <= 0:
            raise AssertionError(f"pallas_bench {name}: a kernel never "
                                 f"launched: {launches[name]}")
        lines[name] = line
    emit({"phase": "kernel_bench_cli", "runs": lines, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    return launches


def phase_devices_cli() -> None:
    """``cli.devices.main`` on the card: its device line names the card
    and its matmul smoke passes."""
    import io

    import torch

    from sgc_tpu_torch.cli import devices

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = devices.main([])
    text = buf.getvalue()
    name = torch.cuda.get_device_name(0)
    if rc != 0 or f"device 0: {name}" not in text or "OK" not in text:
        raise AssertionError(f"cli.devices (rc {rc}): {text!r}")
    emit({"phase": "devices_cli", "output": text.splitlines()})


# the probes' default shapes (scripts/exp_take_probe.py and
# scripts/exp_gather_probe.py); the other probes have fixed shapes
PROBE_TAKE = {"wcols": 2048, "f": 768, "chunk": 1024, "chunks": 64}
PROBE_GATHER = {"rows": 2048, "wcols": 2048, "f": 768, "chunk": 1024,
                "chunks": 64}
PROBE_REPEATS = 5
# calls a launch-bound kernel (E, F at the DMA probe's shape) is timed
# over, and kernel F at the take probe's shape
LAUNCH_CALLS = 1000
TAKE_REPS = 50


def held(fn, plain, tol: float) -> dict:
    """A kernel's wrapper ``fn`` twice and its plain version once on the
    same inputs: the same bits twice and within ``tol`` of max|plain|."""
    import torch

    got, again, want = fn(), fn(), plain()
    if not torch.equal(got, again):
        raise AssertionError("two launches differ")
    abs_err, err = rel_err(got, want)
    if not err <= tol:
        raise AssertionError(f"kernel vs plain: rel err {err:.3e} > {tol}")
    return {"max_abs_err": abs_err, "rel_err": err}


def sm_clock_ghz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in GHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) / 1e3


def fadd_cycles_per_link() -> float:
    """Cycles of one dependent f32 add on the card: kernel G's library
    times a chain of 2^20 adds on one thread (the chain bound's link)."""
    import torch

    from sgc_tpu_torch.ops import kernels

    n = 1 << 20
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    kernels.check_launch(kernels.entry("edge_accumulate", "edge_chain_cycles")(
        cycles.data_ptr(), sink.data_ptr(), n, kernels.stream_of(sink)),
        "edge_chain_cycles")
    torch.cuda.synchronize()
    return int(cycles) / n


def probe_rows(plan, x, probe, reps) -> list:
    """Kernels E-H held against their plain versions (E and F exactly,
    by ``torch.equal``, F on both of its paths: the bulk-copy ring at
    every depth and, on the table 4 bytes off its alignment, the 4-byte
    load and ``cp.async`` paths; G and H within TOLERANCE; the same bits
    over two launches each) on the probe path's inputs, and timed beside
    their bounds, plain versions and library calls, each with its device
    time under ``torch.profiler``. E and F at the DMA probe's shape are
    launch-bound: timed over LAUNCH_CALLS calls beside the launch floor
    (one empty launch through the port's path, ``kernel_ab.launch_floor``);
    F beside the write ceiling (``zero_()`` on its output, the card's rate
    for pure writes). G's bucket and accumulate passes are
    timed apart, and its chain bound (the longest row's dependent adds
    at the measured FADD latency and the card's clock) stands beside its
    byte bound; H's time beside its byte bound and its dense form's
    compute floor, with the bytes its tiles read. These launches are not
    the path's."""
    import torch

    from sgc_tpu_torch.ops import blockdense_int8 as h
    from sgc_tpu_torch.ops import capability
    from sgc_tpu_torch.ops import edge_accumulate as ea
    from sgc_tpu_torch.ops import probe_copy as pe
    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import row_gather as rg
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.scripts import exp_pallas_probe2 as p2
    from sgc_tpu_torch.tools.kernel_ab import launch_floor, profiled_launch_ms

    def timed(fn, plain=None, library=None, n=reps) -> dict:
        return {"ms": time_ms(fn, n),
                "plain_ms": time_ms(plain, 1) if plain else None,
                "library_ms": time_ms(library, n) if library else None}

    def exact(fn, plain) -> dict:
        """``held`` at no tolerance, and ``torch.equal`` to the plain
        version on the same inputs."""
        out = held(fn, plain, 0.0)
        if not torch.equal(fn(), plain()):
            raise AssertionError("kernel vs plain: bits differ")
        return out

    def device_ms(rows: dict, fns: dict) -> None:
        """Each ``fns`` entry's mean device time a launch under one
        ``torch.profiler`` session of 10 calls each, into
        ``rows[entry]["device_ms"]`` (None if the profiler saw none) and
        the launches it recorded into ``"device_launches"``; ``fns`` maps
        an entry to (its kernel's name with its template arguments, and a
        call that launches it once)."""
        got = profiled_launch_ms(
            lambda: [fn() for _, fn in fns.values()], 10)
        for entry, (kernel, _) in fns.items():
            seen = [v for key, v in got.items() if kernel + "(" in key]
            rows[entry]["device_ms"] = seen[0]["ms"] if seen else None
            rows[entry]["device_launches"] = sum(v["launches"]
                                                 for v in seen)

    def in_turns(fn, library, n: int) -> tuple[float, float]:
        """``fn`` and ``library`` timed over ``n`` calls each in the
        order fn, library, library, fn: the mean of each one's turns."""
        a, b = time_ms(fn, n), time_ms(library, n)
        b, a = (b + time_ms(library, n)) / 2, (a + time_ms(fn, n)) / 2
        return a, b

    # the launch floor: one empty launch a call through the port's path,
    # and back to back inside one C call
    floor = launch_floor(probe["scale2_x"])

    # E: both entries at the probes' shapes, launch-bound: timed over
    # LAUNCH_CALLS calls, scale2 in turns with torch.mul
    ex = probe["scale2_x"]
    sx, sel = probe["select_inputs"]
    e_fns = {"scale2": ("scale2_kernel", lambda: pe.scale2(ex)),
             "select_blocks": ("select_blocks_kernel",
                               lambda: pe.select_blocks(sx, sel, p2.B))}
    e = {"scale2": {**exact(e_fns["scale2"][1],
                            lambda: pe.scale2_plain(ex)),
                    **timed(e_fns["scale2"][1], lambda: pe.scale2_plain(ex),
                            n=LAUNCH_CALLS)},
         "select_blocks": {
             **exact(e_fns["select_blocks"][1],
                     lambda: pe.select_blocks_plain(sx, sel, p2.B)),
             **timed(e_fns["select_blocks"][1],
                     lambda: pe.select_blocks_plain(sx, sel, p2.B),
                     n=LAUNCH_CALLS)}}
    device_ms(e, e_fns)
    e["scale2"]["ms"], e["scale2"]["library_ms"] = in_turns(
        e_fns["scale2"][1], lambda: torch.mul(ex, 2.0), LAUNCH_CALLS)
    e["scale2"]["bound"] = rf.copy_bound(
        ex.numel(), ex.numel(), 0, 1, floor["per_python_call_ms"])
    n_sel = int(torch.unique(sel).numel()) * p2.B * sx.shape[1]
    e["select_blocks"]["bound"] = rf.copy_bound(
        n_sel, sel.numel() * p2.B * sx.shape[1], sel.numel(), 1,
        floor["per_python_call_ms"])

    # F: both entries at the take probe's shape, async at every depth, the
    # 4-byte paths (load and cp.async) on the same table 4 bytes off its
    # alignment, over TAKE_REPS calls; async at the DMA probe's shape
    # (launch-bound) over LAUNCH_CALLS. torch.index_select was timed
    # before any launch of kernel F (phase_probe_path): F's evict-last
    # reads leave the table favoured in L2, which a later library call
    # would inherit; it is timed again here, after them
    tx, tidx = probe["take_inputs"]
    tidx64 = tidx.long()
    buf = torch.empty(tx.numel() + 1, device=tx.device)
    tx_off = buf[1:].view_as(tx)
    tx_off.copy_(tx)
    sms = rg.sms_of(tx)
    f_fns = {"load": ("gather_load_kernel<float4>",
                      lambda: rg.row_gather(tx, tidx, "load"))}
    f_fns.update({f"async_{n}": (f"gather_bulk_kernel<{n}>",
                                 lambda n=n: rg.row_gather(tx, tidx, "async",
                                                           n))
                  for n in rg.IN_FLIGHT})
    f_fns["load_4byte"] = ("gather_load_kernel<float>",
                           lambda: rg.row_gather(tx_off, tidx, "load"))
    f_fns["cp_async_8"] = ("gather_cp_kernel<8>",
                           lambda: rg.row_gather(tx_off, tidx, "async"))
    f = {}
    for name, (_, fn) in f_fns.items():
        f[name] = {**exact(fn, lambda: rg.row_gather_plain(tx, tidx)),
                   **timed(fn, n=TAKE_REPS)}
    f["load"].update(
        plain_ms=time_ms(lambda: rg.row_gather_plain(tx, tidx), 1),
        library_ms=probe["take_library_ms"],
        library_ms_after=time_ms(lambda: torch.index_select(tx, 0, tidx64),
                                 TAKE_REPS))
    for name, entry, aligned in (("load", "load", True),
                                 ("load_4byte", "load", False),
                                 ("cp_async_8", "async", False)):
        f[name]["plan"] = rg.gather_plan(tidx.numel(), tx.shape[1], entry,
                                         aligned=aligned, sms=sms).__dict__
    device_ms(f, f_fns)
    del buf, tx_off
    zeroed = torch.empty((tidx.numel(), tx.shape[1]), device=tx.device)
    write_ceiling_ms = time_ms(zeroed.zero_, TAKE_REPS)
    del zeroed
    dx, dcols = probe["dma_inputs"]
    dma = {"dma_shape_async_8": {
        **exact(lambda: rg.row_gather(dx, dcols, "async"),
                lambda: rg.row_gather_plain(dx, dcols)),
        **timed(lambda: rg.row_gather(dx, dcols, "async"),
                lambda: rg.row_gather_plain(dx, dcols),
                lambda: torch.index_select(dx, 0, dcols.long()),
                LAUNCH_CALLS),
        "bound": rf.copy_bound(
            int(torch.unique(dcols).numel()) * dx.shape[1],
            dcols.numel() * dx.shape[1], dcols.numel(),
            launch_floor_ms=floor["per_python_call_ms"])}}
    device_ms(dma, {"dma_shape_async_8": (
        "gather_bulk_kernel<8>", lambda: rg.row_gather(dx, dcols, "async"))})
    f.update(dma)
    n_f = tidx.numel() * tx.shape[1]
    f_bound = rf.copy_bound(int(torch.unique(tidx).numel()) * tx.shape[1],
                            n_f, tidx.numel(),
                            launch_floor_ms=floor["per_python_call_ms"])

    # G: every mode on the gather probe's edges; the bucket pass and the
    # accumulate pass apart; the chain bound of the longest row
    rows_, cols_, vals_, gx = probe["gather_inputs"]
    R, F = PROBE_GATHER["rows"], gx.shape[1]
    fadd_cycles, clock_ghz = fadd_cycles_per_link(), sm_clock_ghz()
    g = {}
    for mode in ea.MODES:
        run = lambda m=mode: ea.edge_accumulate(rows_, cols_, vals_, gx, R, m)
        plain = lambda m=mode: ea.edge_accumulate_plain(rows_, cols_, vals_,
                                                        gx, R, m)
        r_eff, c_eff = ea.effective_edges(rows_, cols_, mode)
        ops, nbytes = rf.edges_count(rows_.numel(), R,
                                     int(torch.unique(c_eff).numel()), F)
        buckets = ea.bucket_edges(rows_, cols_, vals_, gx, R, mode)
        longest = int(torch.bincount(r_eff.long(), minlength=R).max())
        if mode == "store":   # one product a row: no chain of adds
            longest = 1
        g[mode] = {**held(run, plain, TOLERANCE), "ms": time_ms(run, reps),
                   "bucket_ms": time_ms(lambda m=mode: ea.bucket_edges(
                       rows_, cols_, vals_, gx, R, m), reps),
                   "accumulate_ms": time_ms(lambda m=mode, b=buckets:
                                            ea.accumulate_buckets(
                                                b, gx, R, m), reps),
                   "bound": rf.bound_ms(ops, nbytes), "ops": ops,
                   "bytes": nbytes, "longest_row": longest,
                   "chain_bound_ms": rf.chain_bound_ms(longest, fadd_cycles,
                                                       clock_ghz)}
        del buckets
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        a_csr = torch.sparse_coo_tensor(
            torch.stack([rows_.long(), cols_.long()]), vals_,
            (R, gx.shape[0])).coalesce().to_sparse_csr()
    g["rmw"]["plain_ms"] = time_ms(lambda: ea.edge_accumulate_plain(
        rows_, cols_, vals_, gx, R, "rmw"), 1)
    g["rmw"]["library_ms"] = time_ms(lambda: torch.sparse.mm(a_csr, gx), reps)
    src = vals_.unsqueeze(1) * gx[cols_.long()]
    zero = gx.new_zeros((R, F))
    g["rmw"]["index_add_ms"] = time_ms(
        lambda: zero.clone().index_add_(0, rows_.long(), src), reps)
    del a_csr, src, zero

    # H: the main split's cells, both feature tiles, beside kernel A
    split, dargs = plan.split_main, plan._device_args()[0]
    cells = probe["dense"]["quantized"]
    if not (split.rb_ids[: split.n_cells][1:]
            < split.rb_ids[: split.n_cells][:-1]).any():
        raise AssertionError("the main split is not in super-row order")
    hh = {}
    for ft, leg in probe["dense"]["int8"].items():
        xp = leg["xp"]
        hh[ft] = held(lambda: h.apply_cells_int8(cells, xp),
                      lambda: h.apply_cells_int8_plain(cells, xp), TOLERANCE)
        hh[ft]["ms"] = time_ms(lambda: h.apply_cells_int8(cells, xp), reps)
        hh[ft]["traffic"] = rf.kernel_h_traffic(cells, int(xp.shape[1]))
    xp = probe["dense"]["int8"][768]["xp"]
    hh[768]["plain_ms"] = time_ms(lambda: h.apply_cells_int8_plain(cells, xp),
                                  1)
    k_i, r_i, w_i = cells.cells.nonzero(as_tuple=True)
    nnz = int(k_i.numel())
    rb_of = torch.as_tensor(split.rb_ids, device=x.device).long()
    st_of = cells.st_ids.long()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        h_csr = torch.sparse_coo_tensor(
            torch.stack([rb_of[k_i] * split.row_block + r_i,
                         st_of[k_i] * split.stripe + w_i]),
            h.dequantize(cells.cells[k_i, r_i, w_i], cells.scales[k_i]),
            (cells.n_rb * split.row_block, xp.shape[0])
        ).coalesce().to_sparse_csr()
    del k_i, r_i, w_i
    xpf = xp.float()
    zero = xpf.new_zeros((h_csr.shape[0], xp.shape[1]))
    hh[768]["library_ms"] = time_ms(
        lambda: torch.addmm(zero, h_csr, xpf, beta=0.0), reps)
    del h_csr, xpf, zero
    h_bound = rf.kernel_h_bound(cells, nnz, int(xp.shape[1]))
    h_bound["byte_bound_share"] = h_bound["bound_ms"] / hh[768]["ms"]
    h_bound["dense_form_floor_share"] = (h_bound["dense_form_bound_ms"]
                                         / hh[768]["ms"])
    F_x = int(x.shape[1])
    a_bf16 = {"ms": time_ms(lambda: bd.apply_cells(split, dargs, x, "bf16"),
                            reps),
              **rf.kernel_a_bound(split, dargs, split.n_cells, F_x, 1)}

    # the reference's other probe, scalar_prefetch_compiles, is the
    # capability check: its time once the libraries are built and loaded
    capability._PASSED.clear()
    t0 = time.perf_counter()
    capability.require_cuda_kernels(x.device)
    capability_warm_s = time.perf_counter() - t0

    launches, by_entry = probe["launches"], probe["by_entry"]
    return [
        {"name": "probe_copy", "route": "cuda",
         "source": "sgc_tpu_torch/csrc/probe_copy.cu",
         "replaces": "scripts/exp_pallas_probe.py:14, "
                     "scripts/exp_pallas_probe2.py:25",
         "launches": launches["probe_copy"],
         "launches_by_entry": by_entry["probe_copy"],
         "max_abs_err": max(v["max_abs_err"] for v in e.values()),
         "ms": e["scale2"]["ms"], "plain_ms": e["scale2"]["plain_ms"],
         "bound_ms": e["scale2"]["bound"]["bound_ms"],
         "bound_by": e["scale2"]["bound"]["bound_by"],
         "library_ms": e["scale2"]["library_ms"],
         "library": "torch.mul(x, 2.0) (scale2); select_blocks has none",
         "device_ms": e["scale2"]["device_ms"],
         "launch_floor_ms": floor["per_python_call_ms"],
         "launch_floor": floor, "calls_timed": LAUNCH_CALLS,
         "entries": e, "capability_warm_s": capability_warm_s},
        {"name": "row_gather", "route": "cuda",
         "source": "sgc_tpu_torch/csrc/row_gather.cu",
         "replaces": "scripts/exp_take_probe.py:52, "
                     "scripts/exp_dma_gather_probe.py:38",
         "launches": launches["row_gather"],
         "launches_by_entry": by_entry["row_gather"],
         "max_abs_err": max(v["max_abs_err"] for v in f.values()),
         "ms": f["load"]["ms"], "plain_ms": f["load"]["plain_ms"],
         "bound_ms": f_bound["bound_ms"], "bound_by": f_bound["bound_by"],
         "library_ms": f["load"]["library_ms"],
         "library": "torch.index_select(x, 0, idx), timed before kernel "
                    "F's first launch (library_ms_after: after them)",
         "device_ms": f["load"]["device_ms"],
         "write_ceiling_ms": write_ceiling_ms,
         "launch_floor_ms": floor["per_python_call_ms"], "entries": f},
        {"name": "edge_accumulate", "route": "cuda",
         "source": "sgc_tpu_torch/csrc/edge_accumulate.cu",
         "replaces": "scripts/exp_gather_probe.py:64",
         "launches": launches["edge_accumulate"],
         "launches_by_mode": by_entry["edge_accumulate"],
         "max_abs_err": max(v["max_abs_err"] for v in g.values()),
         "ms": g["rmw"]["ms"], "plain_ms": g["rmw"]["plain_ms"],
         "bound_ms": g["rmw"]["bound"][0], "bound_by": g["rmw"]["bound"][1],
         "library_ms": g["rmw"]["library_ms"],
         "library": "torch.sparse.mm of the edges as a CSR matrix (rmw's "
                    "sum; index_add_ms: index_add_ of v x[c], atomic)",
         "bucket_ms": g["rmw"]["bucket_ms"],
         "accumulate_ms": g["rmw"]["accumulate_ms"],
         "chain_bound_ms": {m: g[m]["chain_bound_ms"]
                            for m in ("fixed_out", "noop")},
         "fadd_cycles_per_link": fadd_cycles, "sm_clock_ghz": clock_ghz,
         "modes": g},
        {"name": "blockdense_int8_cells", "route": "cuda",
         "source": "sgc_tpu_torch/csrc/blockdense_int8.cu",
         "replaces": "scripts/exp_dense_term.py:129",
         "launches": launches["blockdense_int8_cells"],
         "max_abs_err": max(v["max_abs_err"] for v in hh.values()),
         "ms": hh[768]["ms"], "plain_ms": hh[768]["plain_ms"],
         "bound_ms": h_bound["bound_ms"], "bound_by": h_bound["bound_by"],
         "library_ms": hh[768]["library_ms"],
         "library": "torch.addmm, the dequantized cells' nonzeros as one "
                    "CSR matrix against bf16(x) widened",
         "rel_err": hh[768]["rel_err"],
         "feature_tiles": hh, "cells": split.n_cells,
         "slots": int(cells.cells.shape[0]), **h_bound,
         "kernel_a_bf16": a_bf16}]


def phase_probe_path(plan, x, reps) -> dict:
    """The ported probes (``sgc_tpu_torch/scripts``), each script's
    ``run`` at its defaults with every kernel's counter (A-D's and
    E-H's) zeroed just before and read just after: exp_pallas_probe and
    exp_pallas_probe2 (kernel E), exp_take_probe and exp_dma_gather_probe
    (F), exp_gather_probe in every mode (G), exp_dense_term on the main
    path's split (kernel A at "bf16" and H at both feature tiles, in
    super-row order). Every kernel E-H and entry, and kernel A, must have
    launched and every script's check passed; then ``probe_rows`` holds
    and times each. Returns A-D's launches under ``"launches"`` for the
    rows' ``launches_by_path``."""
    import io

    import torch

    from sgc_tpu_torch.bench import LAUNCH_COUNTERS
    from sgc_tpu_torch.ops import edge_accumulate as ea
    from sgc_tpu_torch.ops import row_gather as rg
    from sgc_tpu_torch.scripts import (
        exp_dense_term,
        exp_dma_gather_probe,
        exp_gather_probe,
        exp_pallas_probe,
        exp_pallas_probe2,
        exp_take_probe,
    )
    from sgc_tpu_torch.utils.profiling import read_counts, zero_counts

    t0 = time.perf_counter()
    dev = x.device
    # each module's launches by entry (kernel G's by mode)
    entries = {"probe_copy": {e: f"launch.probe_{e}"
                              for e in ("scale2", "select_blocks")},
               "row_gather": {e: f"launch.row_gather_{e}"
                              for e in rg.ENTRIES},
               "edge_accumulate": {m: f"within.edge_accumulate.{m}"
                                   for m in ea.MODES}}

    def placed(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    take_in = placed(exp_take_probe.make_inputs(**PROBE_TAKE))
    dma_in = placed(exp_dma_gather_probe.make_inputs())
    gather_in = placed(exp_gather_probe.make_inputs(**PROBE_GATHER))
    select_in = exp_pallas_probe2.make_inputs(dev)
    dargs = plan._device_args()[0]
    # the library call at the take probe's shape, before kernel F's
    # evict-last reads favour the table in L2 (probe_rows times it again)
    tx, tidx64 = take_in[0], take_in[1].long()
    take_library_ms = time_ms(lambda: torch.index_select(tx, 0, tidx64),
                              TAKE_REPS)
    del tx, tidx64
    torch.cuda.synchronize()
    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        e1 = exp_pallas_probe.run(dev)
        e2 = exp_pallas_probe2.run(*select_in)
        take = exp_take_probe.run(*take_in, PROBE_REPEATS)
        dma = exp_dma_gather_probe.run(*dma_in)
        gather = {m: exp_gather_probe.run(*gather_in, PROBE_GATHER["rows"],
                                          m, PROBE_REPEATS)
                  for m in ea.MODES}
        dense = exp_dense_term.run(plan.split_main, x, dargs, reps=3)
    torch.cuda.synchronize()
    by_entry = {name: read_counts(d) for name, d in entries.items()}
    launches = {name: sum(d.values()) for name, d in by_entry.items()}
    launches["blockdense_int8_cells"] = read_counts(
        ["launch.blockdense_int8_cells"])["launch.blockdense_int8_cells"]
    launches_a_d = read_counts(LAUNCH_COUNTERS)
    path_s = time.perf_counter() - t0
    log(out.getvalue().rstrip())
    if min([*launches.values(), launches_a_d["blockdense_cells"]]
           + [n for d in by_entry.values() for n in d.values()]) <= 0:
        raise AssertionError(f"probe_path: a kernel or entry never "
                             f"launched: {launches} {by_entry} "
                             f"{launches_a_d}")
    if not (e2["correct"] and dma["correct"]) or any(
            r["err"] != 0.0 for r in take.values()):
        raise AssertionError("probe_path: a copy probe is not exact")
    if not gather["rmw"]["rel_err_vs_oracle"] <= TOLERANCE:
        raise AssertionError("probe_path: rmw against the scatter-add "
                             f"oracle {gather['rmw']['rel_err_vs_oracle']}")
    probe = {"launches": launches, "by_entry": by_entry, "dense": dense,
             "scale2_x": e1["x"], "select_inputs": select_in,
             "take_inputs": take_in, "dma_inputs": dma_in,
             "take_library_ms": take_library_ms,
             "gather_inputs": gather_in}
    t1 = time.perf_counter()
    rows = probe_rows(plan, x, probe, reps)
    wall_s = time.perf_counter() - t0
    emit({"phase": "probe_path", "path_s": path_s,
          "held_s": time.perf_counter() - t1, "wall_s": wall_s,
          "launches": launches, "launches_a_d": launches_a_d,
          "by_entry": by_entry,
          "scripts": {
              "exp_pallas_probe": {k: e1[k] for k in ("build_s",
                                                      "launch_s")},
              "exp_pallas_probe2": {k: e2[k] for k in ("seconds",
                                                       "correct")},
              "exp_take_probe": take, "exp_dma_gather_probe":
                  {"correct": dma["correct"]},
              "exp_gather_probe": {m: {k: v for k, v in r.items()
                                       if k != "out"}
                                   for m, r in gather.items()},
              "exp_dense_term": {
                  k: dense[k] for k in ("dispatch_floor_ms",
                                        "kernel_a_bf16_ms", "cells",
                                        "slots")} | {
                  "int8": {ft: {k: v for k, v in leg.items()
                                if k not in ("xp", "out")}
                           for ft, leg in dense["int8"].items()}}},
          "tolerance_rel": TOLERANCE, "rows": rows})
    return {"rows": rows, "wall_s": wall_s,
            "launches": {"scripts": launches_a_d}}


# the experiments' sizes in script_path: the reference's defaults, except
# exp_beyond_device and exp_beyond_stages (SGC_BEYOND_SCALE; the
# full-scale run is a call of its own, PERF.md), whose ranks hold every
# kernel call of their hops
SCRIPT_BEYOND_SCALE = 0.05
SCRIPT_BEYOND_EPOCHS = 2
SCRIPT_SIZES = {"topology": 0.25, "newton": 0.25, "pad": 1.0,
                "crossover": (0.05, 0.1, 0.25, 0.5), "flat": 0.1,
                "hybrid": 1.0, "lbfgs": (152_410, 602, 41)}
SCRIPT_CUTS = {
    "exp_beyond_device": f"SGC_BEYOND_SCALE {SCRIPT_BEYOND_SCALE} (the "
                         "reference's 1.0: 2.4M x 2,048), "
                         f"SGC_BEYOND_EPOCHS {SCRIPT_BEYOND_EPOCHS} (5)",
    "exp_beyond_stages": f"SGC_BEYOND_SCALE {SCRIPT_BEYOND_SCALE} (0.25)",
    "exp_super_rows": "the main path's plan (committed admission; the "
                      "calibrated split admits no cell on the H100)",
}


@contextlib.contextmanager
def uncounted():
    """Kernel calls inside the block (a hold's second launch) leave every
    counter as it was: what the block counted is taken off again."""
    from sgc_tpu_torch.utils.profiling import count, read_counts

    saved = read_counts()
    try:
        yield
    finally:
        for name, n in read_counts().items():
            count(name, saved.get(name, 0) - n)


class Holds:
    """Kernel launches held against their plain versions on the same
    inputs at ``TOLERANCE``, the largest error per kernel kept. Each
    method launches the kernel once more, as the script did, and returns
    its output; the caller runs it under :func:`uncounted`."""

    def __init__(self):
        self.errs = {}

    def add(self, name: str, got, want) -> None:
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"script_path: {name} vs plain: {err:.3e}")
        e = self.errs.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                        "rel_err": 0.0})
        e["calls"] += 1
        e["max_abs_err"] = max(e["max_abs_err"], abs_err)
        e["rel_err"] = max(e["rel_err"], err)

    def b(self, graph, x, dense=None):
        from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

        out = spmm_segment(graph, x, dense)
        self.add("csr_spmm", out, spmm_segment_plain(graph, x, dense))
        return out

    def a(self, split, args, x, precision):
        from sgc_tpu_torch.ops import spmm_blockdense as bd

        out = bd.apply_cells(split, args, x, precision)
        self.add("blockdense_cells", out,
                 bd.apply_cells_plain(split, args, x, precision))
        return out

    def c(self, tiled, args, x, precision):
        from sgc_tpu_torch.ops import spmm_tiled as tl

        out = tl.spmm_tiled_flat(tiled, x, args, precision)
        self.add("tiled_spmm", out, tl.spmm_tiled_plain(tiled, x, precision))
        return out

    def hop(self, split, args, x, onehot: bool, precision: str = "f32"):
        """One hop of a block-dense (A + B) or hybrid (C + B) split."""
        dense = None
        if onehot and split.tiled is not None:
            dense = self.c(split.tiled, args.tiled, x, precision)
        elif not onehot and split.n_cells:
            dense = self.a(split, args, x, precision)
        if args.rest is not None:
            return self.b(args.rest, x, dense)
        return dense

    def plan_hops(self, plan, want):
        """A plan's ``khop_traceable(degree=2)`` hop by hop; the result
        must be ``want`` (the script's rows) bit for bit."""
        import torch

        onehot = plan.formulation == "onehot"
        a_main, a_final = plan._device_args()
        x = torch.as_tensor(plan.features, device=plan.device)
        out = self.hop(plan.split_final, a_final,
                       self.hop(plan.split_main, a_main, x, onehot), onehot)
        if not torch.equal(out, want):
            raise AssertionError(f"script_path: held {plan.formulation} "
                                 "hops differ from the script's rows")


def rank_launches(per_rank: list) -> dict:
    """The launches of kernels A-D summed over a world's ranks."""
    from sgc_tpu_torch.bench import LAUNCH_COUNTERS

    return {k: sum(r[k] for r in per_rank) for k in LAUNCH_COUNTERS}


def ranks_held(per_rank: list, launches: list) -> dict:
    """Every rank held each of its kernel-B calls (one held call per
    launch) within ``TOLERANCE``; the largest error over the ranks."""
    for held_r, n in zip(per_rank, launches):
        got = held_r.get("csr_spmm", {}).get("calls", 0)
        if got != n["csr_spmm"] or n["csr_spmm"] <= 0:
            raise AssertionError(f"script_path: a rank held {got} of its "
                                 f"{n['csr_spmm']} kernel-B launches")
        if not held_r["csr_spmm"]["rel_err"] <= TOLERANCE:
            raise AssertionError(f"script_path: rank kernel B vs plain: "
                                 f"{held_r['csr_spmm']}")
    return {"calls": sum(h["csr_spmm"]["calls"] for h in per_rank),
            "max_abs_err": max(h["csr_spmm"]["max_abs_err"]
                               for h in per_rank),
            "rel_err": max(h["csr_spmm"]["rel_err"] for h in per_rank)}


def need(launches: dict, kernels: tuple, script: str) -> None:
    """Raise unless each of ``kernels`` launched during the script."""
    if any(launches[k] <= 0 for k in kernels):
        raise AssertionError(f"script_path: {script} never launched one of "
                             f"{kernels}: {launches}")


def phase_script_path(plan, x) -> dict:
    """The ported experiments (``sgc_tpu_torch/scripts``), each through its
    ``run(...)`` at its reference script's defaults (cuts in
    ``SCRIPT_CUTS``), kernels A-D's counters zeroed just before each run
    and read just after: exp_topology_sweep (scale 0.25, the full grid),
    exp_beyond_device and exp_beyond_stages (an NCCL world of one rank,
    the ranks' own counters), exp_newton_head (scale 0.25),
    exp_lbfgs_cost (the Reddit train shape), exp_pad_study (scale 1.0,
    host only), exp_crossover (uniform, scales 0.05-0.5), exp_flat_sweep
    (0.1), exp_hybrid_sweep (1.0) and exp_super_rows (the main path's
    plan). Every kernel launch of a script's hops is held against its
    plain version on the same inputs at ``TOLERANCE`` (a second launch,
    made uncounted inside the script's callbacks, that must give the
    script's rows bit for bit where it recomputes them), and each
    script's host results are checked. A failed check raises.

    The speed verdicts are printed, not enforced: the topology sweep's
    ``pass`` (auto <= segment x 1.15) and which form wins the crossover.
    ``exp_topology_sweep.main`` keeps the reference's exit code, the
    contract of its command line, not a check of the port."""
    import io

    import torch

    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.scripts import (
        exp_beyond_device,
        exp_beyond_stages,
        exp_crossover,
        exp_flat_sweep,
        exp_hybrid_sweep,
        exp_lbfgs_cost,
        exp_newton_head,
        exp_pad_study,
        exp_super_rows,
        exp_topology_sweep,
    )

    t_phase = time.perf_counter()
    dev = x.device
    holds = Holds()
    launches, seconds, out = {}, {}, {}

    def script(name, fn, kernels=()):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result, n = counted(fn)
        seconds[name] = time.perf_counter() - t0
        launches[name] = n
        log(buf.getvalue().rstrip())
        need(n, kernels, name)
        return result, buf.getvalue()

    # the topology sweep, every hop held as its plan runs it
    def topo_held(res):
        with uncounted():
            g1, g2, xs = res["segment"]
            h = holds.b(g1.to(dev), xs)
            if not torch.equal(holds.b(g2.to(dev), h),
                               res["outputs"]["segment"]):
                raise AssertionError("script_path: held segment hops differ")
            for form, p in res["plans"].items():
                holds.plan_hops(p, res["outputs"][form])

    rows, _ = script("exp_topology_sweep", lambda: exp_topology_sweep.run(
        SCRIPT_SIZES["topology"], dev, on_config=topo_held), ("csr_spmm", "tiled_spmm",
                                          "blockdense_cells"))
    if [r["config"] for r in rows] != [n for n, _ in
                                       exp_topology_sweep.grid()]:
        raise AssertionError("script_path: topology sweep configs")
    out["exp_topology_sweep"] = {
        "rows": rows, "verdict": f"{sum(r['pass'] for r in rows)}/"
                                 f"{len(rows)} configs pass (printed, not "
                                 "enforced)"}

    # features beyond a device: the ranks count and hold their own calls
    torch.cuda.empty_cache()
    beyond, _ = script("exp_beyond_device", lambda: exp_beyond_device.run(
        SCRIPT_BEYOND_SCALE, SCRIPT_BEYOND_EPOCHS, dev, hold=True))
    launches["exp_beyond_device"] = rank_launches(beyond["_launches"])
    need(launches["exp_beyond_device"], ("csr_spmm",), "exp_beyond_device")
    beyond_held = ranks_held(beyond["_held"], beyond["_launches"])
    if beyond["exceeds_device_memory"] or not (
            beyond["train_accuracy"] > 1.0 / exp_beyond_device.N_CLASSES):
        raise AssertionError(f"script_path: exp_beyond_device {beyond}")
    out["exp_beyond_device"] = {k: v for k, v in beyond.items()
                                if not k.startswith("_")}
    stages, _ = script("exp_beyond_stages", lambda: exp_beyond_stages.run(
        SCRIPT_BEYOND_SCALE, dev, hold=True))
    launches["exp_beyond_stages"] = rank_launches(stages["launches"])
    need(launches["exp_beyond_stages"], ("csr_spmm",), "exp_beyond_stages")
    stages_held = ranks_held(stages["held"], stages["launches"])
    if len(stages["rows"]) != 11:
        raise AssertionError("script_path: exp_beyond_stages stages")
    out["exp_beyond_stages"] = [list(r) for r in stages["rows"]]

    # the head
    def newton():
        tr, y, p = exp_newton_head.propagated(
            SCRIPT_SIZES["newton"], dev)
        with uncounted():
            holds.plan_hops(p, tr)
        params0 = init_sgc(torch.Generator().manual_seed(42), tr.shape[1],
                           int(y.max()) + 1, device=dev)
        return exp_newton_head.run(tr, y, params0)

    head, _ = script("exp_newton_head", newton, ("blockdense_cells",
                                                 "csr_spmm"))
    losses = [loss for _, loss, _ in head["iters"]]
    if not all(map(math.isfinite, losses)) or any(
            b > a + 1e-6 * abs(a) for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"script_path: Böhning losses {losses}")
    out["exp_newton_head"] = {k: v for k, v in head.items()}

    n_l, f_l, c_l = SCRIPT_SIZES["lbfgs"]
    xl, yl = exp_lbfgs_cost.make_inputs(n_l, f_l, c_l)
    p0 = init_sgc(torch.Generator().manual_seed(0), f_l, c_l, device=dev)
    lb, _ = script("exp_lbfgs_cost", lambda: exp_lbfgs_cost.run(
        torch.as_tensor(xl, device=dev), torch.as_tensor(yl, device=dev),
        p0))
    del xl, yl
    if not all(bool(torch.isfinite(r["flat"]).all()) for r in lb.values()):
        raise AssertionError("script_path: exp_lbfgs_cost non-finite fit")
    out["exp_lbfgs_cost"] = {m: {k: r[k] for k in ("ms", "iters",
                                                   "ms_per_iter")}
                             for m, r in lb.items()}

    # the onehot geometry
    from sgc_tpu_torch.data.synthetic import synthetic_reddit

    graph1, _, _, _ = synthetic_reddit(SCRIPT_SIZES["pad"])
    pad, _ = script("exp_pad_study", lambda: exp_pad_study.run(graph1))
    del graph1
    if len(pad) != 36 or len({r["c_bound_ms"] for r in pad}) != 1:
        raise AssertionError("script_path: exp_pad_study rows")
    out["exp_pad_study"] = pad

    def cross_held(res):
        with uncounted():
            if not torch.equal(holds.b(res["graph"], res["x"]), res["ref"]):
                raise AssertionError("script_path: held segment differs")
            tiled, targs = res["tiled"]
            for prec in exp_crossover.PRECISIONS:
                holds.c(tiled, targs, res["x"], prec)
            for split, hargs in res["hybrid"].values():
                holds.hop(split, hargs, res["x"], True)

    cross, _ = script("exp_crossover", lambda: exp_crossover.run(
        SCRIPT_SIZES["crossover"], "uniform", dev, on_scale=cross_held),
        ("csr_spmm", "tiled_spmm"))
    if any(r["rel_err"] > TOLERANCE for r in cross
           if r["impl"] in ("tiled_flat_f32", "hybrid")):
        raise AssertionError("script_path: exp_crossover rel_err")
    out["exp_crossover"] = {"rows": cross, "winner_by_scale": {
        s: min((r for r in cross if r["scale"] == s),
               key=lambda r: r["ms"])["impl"]
        for s in sorted({r["scale"] for r in cross})}}

    g01, x01, _, _ = synthetic_reddit(SCRIPT_SIZES["flat"])
    x01 = torch.as_tensor(x01, device=dev)

    def flat_held(tiled, targs):
        with uncounted():
            for prec in exp_crossover.PRECISIONS:
                holds.c(tiled, targs, x01, prec)

    def flat():
        with uncounted():
            holds.b(g01.to(dev), x01)
        return exp_flat_sweep.run(g01, x01, on_tiling=flat_held)

    fl, _ = script("exp_flat_sweep", flat, ("csr_spmm", "tiled_spmm"))
    out["exp_flat_sweep"] = {k: fl[k] for k in ("xla_s", "rows", "best",
                                                "bf16")}
    del g01, x01, fl

    gh, fh = exp_hybrid_sweep.lpa_graph(SCRIPT_SIZES["hybrid"])
    xh = torch.as_tensor(fh, device=dev)

    def hybrid_held(split, hargs):
        with uncounted():
            holds.hop(split, hargs, xh, True)

    hy, _ = script("exp_hybrid_sweep", lambda: exp_hybrid_sweep.run(
        gh, xh, on_split=hybrid_held), ("csr_spmm", "tiled_spmm"))
    out["exp_hybrid_sweep"] = hy
    del gh, fh, xh

    # kernel A's cell order on the main path's plan
    def super_held(name, split, args):
        with uncounted():
            holds.a(split, args, x, "bf16")

    sr, _ = script("exp_super_rows", lambda: exp_super_rows.run(
        plan, x, on_variant=super_held), ("blockdense_cells",))
    loads = {k: r["stripe_loads"] for k, r in sr["rows"].items()}
    if loads["None"] != sr["rows"]["None"]["n_cells"] or not (
            loads["S16"] <= loads["S8"] <= loads["S4"] <= loads["None"]):
        raise AssertionError(f"script_path: stripe loads {loads}")
    out["exp_super_rows"] = sr

    for name, n in holds.errs.items():
        total = sum(launches[s][name] for s in launches)
        if n["calls"] < 1 or total < 1:
            raise AssertionError(f"script_path: {name} not held")
    wall_s = time.perf_counter() - t_phase
    emit({"phase": "script_path", "wall_s": wall_s, "seconds": seconds,
          "launches": launches, "held": holds.errs,
          "held_in_ranks": {"exp_beyond_device": beyond_held,
                            "exp_beyond_stages": stages_held},
          "tolerance_rel": TOLERANCE, "cuts": SCRIPT_CUTS,
          "scripts": out})
    return {"launches": launches, "wall_s": wall_s, "held": holds.errs}


BENCH_TIMEOUT_S = 300
# the kernels each leg of the bench must have launched
BENCH_LEG_KERNELS = {
    "clustered": ("csr_spmm",), "uniform_segment": ("csr_spmm",),
    "uniform_auto": ("csr_spmm",),
    "forms.blockdense_kernel": ("blockdense_cells", "csr_spmm"),
    "forms.onehot": ("tiled_spmm", "csr_spmm")}


def phase_bench_path(args, dense_fracs) -> dict:
    """``python -m sgc_tpu_torch.bench`` as a process at ``--scale``, both
    topologies: exit 0, a compact line of at most COMPACT_MAX_CHARS with
    the metric, every parity gate passed, the calibrated headline's
    dense_frac equal to calibrated_path's and the forms' to main_path's
    and onehot_path's (``dense_fracs``, at the default seed 42, the
    bench's), each leg's launches (from its sidecar) naming its kernels,
    and the sidecar's roofline terms, 8-part plan and comm sweep."""
    import torch

    from sgc_tpu_torch.bench import COMPACT_MAX_CHARS, DETAILS_PATH, FORMS

    torch.cuda.empty_cache()    # the card's memory for the bench process
    t0 = time.perf_counter()
    DETAILS_PATH.unlink(missing_ok=True)
    env = {**os.environ, "SGC_BENCH_SCALE": str(args.scale),
           "SGC_BENCH_TOPOLOGY": "both"}
    for var in ("SGC_BENCH_FORMULATION", "SGC_BENCH_TRAINER",
                "SGC_BENCH_PROFILE_PLAN"):
        env.pop(var, None)
    r = subprocess.run([sys.executable, "-m", "sgc_tpu_torch.bench"],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=env, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    if r.returncode != 0:
        log(r.stderr[-6000:])
        raise AssertionError(f"sgc_tpu_torch.bench exited {r.returncode}")
    line = r.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    c = json.loads(line)
    side = json.loads(DETAILS_PATH.read_text())
    if len(line) > COMPACT_MAX_CHARS:
        raise AssertionError(f"bench line {len(line)} chars")
    if c["metric"] != "reddit_sgc_precompute_train_s":
        raise AssertionError(f"bench metric {c['metric']!r}")
    gates = {"clustered": c["train_parity"]["parity_ok"],
             **{f"forms.{f}": side["forms"][f]["parity_ok"] for f in FORMS}}
    if not all(gates.values()):
        raise AssertionError(f"bench parity gates: {gates}")
    got = {"calibrated": side["legs"]["clustered"]["dense_frac"],
           **{f: side["forms"][f]["dense_frac"] for f in FORMS}}
    if args.seed == 42 and got != dense_fracs:
        raise AssertionError(f"bench dense_frac {got} != the smoke's "
                             f"{dense_fracs}")
    launches = {**{k: v["launches"] for k, v in side["legs"].items()},
                **{f"forms.{f}": side["forms"][f]["launches"]
                   for f in FORMS}}
    for leg, need in BENCH_LEG_KERNELS.items():
        if min(launches[leg][k] for k in need) <= 0:
            raise AssertionError(f"bench leg {leg} never launched one of "
                                 f"{need}: {launches[leg]}")
    for roofline in (side["roofline"],
                     side["forms"]["blockdense_kernel"]["roofline"]):
        if not {"dense", "remainder"} <= set(roofline):
            raise AssertionError(f"bench roofline terms: {set(roofline)}")
    ps = side["projected_scaling"]
    if ps["sharded_blockdense_plan"]["n_parts"] != 8:
        raise AssertionError("bench sharded plan is not 8 parts")
    if not ps["comm_sweep"]["rows"]:
        raise AssertionError("bench comm sweep has no rows")
    legs = {k: {m: v[m] for m in ("total_s", "precompute_s", "dense_frac",
                                  "formulation") if m in v}
            for k, v in side["legs"].items()}
    forms = {f: {m: side["forms"][f][m] for m in (
        "hops_s", "total_s", "dense_frac", "prep_s", "parity_ok")}
        for f in FORMS}
    log(f"bench_path: {bench_s:.1f}s")
    emit({"phase": "bench_path", "line": c, "bench_s": bench_s,
          "card": side["card"], "legs": legs, "forms": forms,
          "launches": launches, "roofline": side["roofline"],
          "forms_blockdense_roofline":
              side["forms"]["blockdense_kernel"]["roofline"],
          "sharded_blockdense_plan": ps["sharded_blockdense_plan"],
          "comm_sweep_rows": len(ps["comm_sweep"]["rows"])})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of Reddit's nodes and edges (1.0 = full)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import sgc_tpu_torch  # noqa: F401
    except ImportError:
        log("chip_smoke: run from a checkout of the repository")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    phase_calibrate(device)
    main = phase_main_path(args, device)
    data = main.pop("data")
    plan = main["plan"]
    dense_fracs = {"blockdense_kernel": plan.dense_fraction}
    sharded_data = (plan.graph, plan.features, plan.labels, plan.idx_train)
    del plan
    phase_prep_attribution(data, main, device)
    dense_fracs["calibrated"] = phase_calibrated_path(data, main.pop("tr"),
                                                      device)
    onehot = phase_onehot_path(data, device)
    dense_fracs["onehot"] = onehot["plan"].dense_fraction
    shuffled = data[:2]
    rows = [phase_kernel_a(main["plan"], main["x"], main["launches"],
                           args.reps)]
    phase_kernel_a_grouped(main["plan"], main["x"], args.reps)
    rows.append(phase_kernel_b(main["plan"], main["x"], main["launches"],
                               args.reps, shuffled))
    phase_roofline(main["plan"], rows)
    probe = phase_probe_path(main["plan"], main["x"], args.reps)
    scripts = phase_script_path(main["plan"], main["x"])
    lpa_rows = main.pop("lpa_rows")
    del main
    rows.append(phase_kernel_c(onehot, args.reps))
    rows.append(phase_kernel_d(onehot, shuffled, args.reps))
    del shuffled
    phase_dispatcher(onehot, args.reps)
    del onehot
    sharded = phase_sharded_path(sharded_data, device, card, args.seed,
                                 args.reps)
    training = phase_sharded_training_path(sharded_data, sharded["root"],
                                           device, card, args.seed,
                                           args.reps)
    del sharded_data
    gat_reddit = phase_gat_reddit(data, device, args.reps)
    t_new = time.perf_counter()
    orderings = phase_ordering_path(data, lpa_rows, device, args.reps)
    by_path = {"ordering_path": orderings["launches"],
               "probe_path": probe["launches"],
               "script_path": scripts["launches"]}
    del data, lpa_rows
    by_path["sharded_path"] = sharded["launches"]
    by_path["sharded_training_path"] = training["launches"]
    by_path["graph_store"] = phase_graph_store(device, args.reps)
    by_path["kernel_bench_cli"] = phase_kernel_bench_cli()
    phase_devices_cli()
    new_paths_s = time.perf_counter() - t_new
    by_path.update({"reddit_cli": phase_reddit_cli(args, device),
               "citation_cli": phase_citation_cli(args, device),
               **phase_train_paths(args, device)})
    text = phase_text_path(args, device, args.reps)
    by_path["text_cli"] = text["launches"]
    by_path["serve_path"] = phase_serve_path(args, device, card, args.reps)
    baselines = phase_text_baselines(args, device, args.reps)
    by_path.update(baselines["launches"])
    by_path["bench_path"] = phase_bench_path(args, dense_fracs)
    by_path["gat_train"]["reddit_2_steps"] = gat_reddit["launches"]
    for row in rows:
        row["launches_by_path"] = {
            path: {run: n[row["name"]] for run, n in runs.items()}
            for path, runs in by_path.items()}
    # the GAT backward's operands on the Reddit-shape graph (F = 8, 41)
    rows[1]["transposed_launches_by_path"] = {
        path: {run: n["csr_spmm_transposed"] for run, n in runs.items()}
        for path, runs in by_path.items()}
    rows[1]["gat_reddit"] = {F: {k: w[k] for k in ("forward_b",
                                                   "transposed_b", "row_sum")
                                 if k in w}
                             for F, w in gat_reddit["widths"].items()}
    rows[0]["max_abs_err"] = max(
        rows[0]["max_abs_err"], text["kernel_a_2048"]["max_abs_err"],
        orderings["max_abs_err"]["blockdense_cells"],
        sharded["max_abs_err"]["blockdense_cells"],
        training["max_abs_err"]["blockdense_cells"])
    rows[1]["max_abs_err"] = max([rows[1]["max_abs_err"],
                                  orderings["max_abs_err"]["csr_spmm"],
                                  sharded["max_abs_err"]["csr_spmm"],
                                  training["max_abs_err"]["csr_spmm"]] + [
        w["max_abs_err"] for w in list(text["kernel_b_widths"].values())
        + list(baselines["w2v_widths"].values()) + [baselines["seq_width"]]])
    rows[0]["text_2048"] = {k: text["kernel_a_2048"][k] for k in (
        "F", "cells", "precision", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "rel_err")}
    rows[1]["text_widths"] = {F: {k: w[k] for k in (
        "ms", "bound_ms", "bound_by", "library_ms", "rel_err", "plan")}
        for F, w in text["kernel_b_widths"].items()}
    rows[1]["word2vec_widths"] = {F: {k: w[k] for k in (
        "nnz", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "csr_addmm_ms", "rel_err", "max_degree", "plan")}
        for F, w in baselines["w2v_widths"].items()}
    rows[1]["seq_widths"] = {"256": {k: baselines["seq_width"][k] for k in (
        "nnz", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "csr_mm_ms", "rel_err", "max_degree", "max_degree_row_alone_ms",
        "plan")}}
    # the sharded GCN's backward kernels at F = 41, each rank alone
    rows[0]["sharded_backward"] = [{k: v for k, v in r.items()
                                    if k.startswith("a_t_")}
                                   for r in training["backward"]]
    rows[1]["sharded_backward"] = [{k: v for k, v in r.items()
                                    if k.startswith("b_")}
                                   for r in training["backward"]]
    rows[3]["gat_reddit_backward"] = {F: w["d"] for F, w in
                                      gat_reddit["widths"].items()
                                      if "d" in w}
    # rank 0's sharded operands alone on the card, beside library calls
    rows[0]["sharded_library"] = sharded["library"]["a"]
    rows[1]["sharded_library"] = sharded["library"]["b"]
    # script_path's held launches (kernels A, B and C)
    for row in rows:
        if row["name"] in scripts["held"]:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     scripts["held"][row["name"]][
                                         "max_abs_err"])
    rows.extend(probe["rows"])
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s (probe_path: "
        f"{probe['wall_s']:.1f}s; script_path: {scripts['wall_s']:.1f}s; "
        "ordering_path, graph_store, "
        f"kernel_bench_cli, devices_cli: {new_paths_s:.1f}s)")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
