"""Kernel B's row order on the card: the kernel walking a permuted CSR
with a row map gives the bits of the kernel in index order, at every
width class, with and without the dense operand, with the CTA order on
and off; ``spmm_segment`` walks a prepared operator's order
(``ops.autograd.prepare_operator``) from its first launch where
``ops.spmm.row_walk`` says so, and counts it; GCNII trains to the same
bits with the order forced on and off.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the reference package, so on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_row_order_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph import reorder
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import gcnii as port_gcnii
from sgc_tpu_torch.ops.autograd import prepare_operator
from sgc_tpu_torch.ops import spmm as sp
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def hub_graph(dev, n=6000, seed=5):
    """A square graph with hub rows: every 11th row empty, every 7th of
    1-3 edges, the rest 4-40, rows 7 and 4001 hubs of 4,500 and 2,000
    edges (more than a staged chunk holds)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(4, 41, n)
    deg[1::7] = rng.integers(1, 4, deg[1::7].size)
    deg[::11] = 0
    deg[7], deg[4001] = 4500, 2000
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, n, n).to(dev)


def community_graph(dev, n=24000, communities=24, avg_degree=20, seed=0):
    """Communities with shuffled ids (90% of the edges inside one),
    symmetric with self loops, normalized by degree."""
    rng = np.random.default_rng(seed)
    size = n // communities
    e = n * avg_degree // 2
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.9,
                   src // size * size + rng.integers(0, size, e),
                   rng.integers(0, n, e))
    ids = rng.permutation(n)
    rows = np.concatenate([ids[src], ids[dst], np.arange(n)])
    cols = np.concatenate([ids[dst], ids[src], np.arange(n)])
    deg = np.bincount(rows, minlength=n).astype(np.float32)
    vals = (deg[rows] * deg[cols]) ** -0.5
    return SparseGraph.from_coo(rows, cols, vals, n, n).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("f", [1, 8, 41, 64, 602])
def test_cuda_kernel_b_row_map_keeps_the_bits(cuda, f, with_dense):
    """The permuted CSR walked with its row map gives the index-order
    kernel's bits, whichever order the CTAs start in."""
    g = hub_graph(cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(g.n_cols, f, device=cuda, generator=gen)
    dense = (torch.randn(g.n_rows, f, device=cuda, generator=gen)
             if with_dense else None)
    want = torch.empty(g.n_rows, f, device=cuda)
    plan = sp.csr_plan(f, False, sp.operand_align(x, dense, want))
    sp.launch_csr(g.row_ptr, g.cols, g.vals, x, dense, want, plan=plan)
    perm = torch.randperm(g.n_rows, device=cuda,
                          generator=torch.Generator(device=cuda)
                          .manual_seed(1))
    walk = sp.walk_rows(g, perm)
    n_ctas = -(-g.n_rows // plan.rows_per_cta)
    for order in (None,
                  sp.heavy_first(walk.row_ptr, g.n_rows, plan.rows_per_cta),
                  torch.arange(n_ctas - 1, -1, -1, device=cuda,
                               dtype=torch.int32)):
        out = torch.full_like(want, float("nan"))
        sp.launch_csr(walk.row_ptr, walk.cols, walk.vals, x, dense, out,
                      plan=plan, cta_order=order, row_map=walk.row_map)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_spmm_segment_engages_the_order_and_counts_it(cuda,
                                                          monkeypatch):
    """With the L2 taken as 0 bytes, a prepared shuffled community graph
    walks LPA's order from its first launch, gives the unprepared
    graph's bits and counts ``within.csr_spmm_ordered``; the unprepared
    graph of the same pattern, however many launches, and the prepared
    one on a table within the L2 do not."""
    g = community_graph(cuda)
    monkeypatch.setattr(reorder, "ORDER_BLOCK", 500)
    monkeypatch.setattr(sp, "l2_bytes", lambda dev: 0)
    prepared = prepare_operator(g)
    assert prepared.walk is not None
    x = torch.randn(g.n_cols, 64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    names = ("launch.csr_spmm", "within.csr_spmm_ordered")
    run = 34

    def counted(graph):
        before = profiling.read_counts(names)
        outs = [sp.spmm_segment(graph, x) for _ in range(run)]
        return outs, {k: n - before[k]
                      for k, n in profiling.read_counts(names).items()}

    plain, got = counted(g)
    assert got == {"launch.csr_spmm": run, "within.csr_spmm_ordered": 0}
    ordered, got = counted(prepared)
    assert got == {"launch.csr_spmm": run, "within.csr_spmm_ordered": run}
    monkeypatch.setattr(sp, "l2_bytes", lambda dev: 4 * g.n_cols * 64)
    fits, got = counted(prepared)
    assert got == {"launch.csr_spmm": run, "within.csr_spmm_ordered": 0}
    torch.cuda.synchronize()
    for out in plain[1:] + ordered + fits:
        assert torch.equal(out, plain[0])


@pytest.mark.cuda
def test_cuda_gcnii_steps_keep_their_bits_with_the_order(cuda,
                                                        monkeypatch):
    """Three Adam steps of an 8-layer GCNII on a shuffled community
    graph: the order forced on (the L2 taken as 0 bytes) and off give
    the same parameters, bit for bit; forced on, every product of the
    prepared operator, forward and backward, walks it from the first
    step."""
    g = community_graph(cuda)
    monkeypatch.setattr(reorder, "ORDER_BLOCK", 500)
    rng = np.random.default_rng(3)
    n, f, h, c, layers = g.n_rows, 64, 64, 8, 8
    x = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                        device=cuda)
    idx = np.sort(rng.choice(n, n // 2, replace=False))
    y = torch.as_tensor(rng.integers(0, c, n)[idx], device=cuda)
    target = port_loops.train_target(n, idx, y)

    def u(shape, fan):
        return torch.as_tensor(rng.uniform(-fan ** -0.5, fan ** -0.5, shape),
                               dtype=torch.float32)

    init = [u((f, h), f), u((h,), f), u((layers, h, h), h), u((h, c), h),
            u((c,), h)]
    names = ("launch.csr_spmm", "within.csr_spmm_ordered")

    def train(l2):
        monkeypatch.setattr(sp, "l2_bytes", lambda dev: l2)
        model = port_gcnii.GCNII(*(t.clone().to(cuda) for t in init))
        scaled = port_gcnii.scaled_operator(g, 0.1)
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        counts = []
        for _ in range(3):
            before = profiling.read_counts(names)
            opt.zero_grad()
            port_loops.node_cross_entropy(port_gcnii.gcnii_apply(
                model, x, scaled, 0.1, 0.5), *target).backward()
            opt.step()
            counts.append({k: v - before[k] for k, v in
                           profiling.read_counts(names).items()})
        torch.cuda.synchronize()
        return model, counts

    on, counts_on = train(0)
    off, counts_off = train(1 << 40)
    for k in ("w_in", "b_in", "w_conv", "w_out", "b_out"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    assert counts_on == 3 * [{"launch.csr_spmm": 2 * layers,
                              "within.csr_spmm_ordered": 2 * layers}]
    assert all(c["within.csr_spmm_ordered"] == 0 for c in counts_off)
