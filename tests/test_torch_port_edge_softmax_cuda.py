"""GAT's attention kernels (``csrc/edge_softmax.cu`` through
``ops/edge_softmax.py``) on the card: each of the five entries gives its
plain version's bits (the composition of PyTorch ops and kernel B's F = 1
sums that the port ran before them) and the same bits on a second
launch, on skewed graphs: hub rows and columns longer than a staged
chunk, spans of many rows longer than one, rows with no edge, padding
slots, and pre-activations on both sides of 0 and exactly at 0. A whole
two-layer ``multi_head_gat`` forward and backward gives the composition's
bits: the logits, the attention values, the output and every leaf's
gradient.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the reference package, so on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_edge_softmax_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import gat as port_gat
from sgc_tpu_torch.ops import edge_softmax as es
from sgc_tpu_torch.ops.autograd import transpose_places
from sgc_tpu_torch.ops.spmm import row_sums
from sgc_tpu_torch.utils import profiling

SLOPE = 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def skewed_graph(dev, n_rows=6001, n_cols=6001, seed=5):
    """Every 11th row empty, every 7th of 1-3 edges, the rest 4-40; row 7
    and a row two thirds down hubs of 4,500 and 2,300 edges (longer than
    a staged chunk); 64 rows from the middle's warp on of 100 edges each
    (spans of 32 rows longer than a chunk with no hub); a fifth of the
    edges on column 17 or the column two thirds along (hub columns of
    the transpose). nnz is no multiple of 1,024, so there is padding."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(4, 41, n_rows)
    deg[1::7] = rng.integers(1, 4, deg[1::7].size)
    mid = n_rows // 64 * 32
    deg[mid:mid + 64] = 100
    deg[::11] = 0
    deg[7], deg[2 * n_rows // 3] = 4500, 2300
    rows = np.repeat(np.arange(n_rows), deg)
    cols = rng.integers(0, n_cols, rows.size)
    hub = rng.random(rows.size) < 0.2
    cols[hub] = np.where(rng.random(int(hub.sum())) < 0.5, 17,
                         2 * n_cols // 3)
    # one edge per (row, col): duplicates would merge in from_coo's sort
    code = np.unique(rows.astype(np.int64) * n_cols + cols)
    rows, cols = code // n_cols, code % n_cols
    vals = np.ones(rows.size, np.float32)
    g = SparseGraph.from_coo(rows, cols, vals, n_rows, n_cols).to(dev)
    assert g.nnz % 1024 and g.n_edges_padded > g.nnz
    return g


def node_scores(n, seed, dev):
    """Multiples of 1/8 in [-2, 2]: dst + src lands exactly on 0 often,
    and on both sides of it."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.integers(-16, 17, n) / 8).astype(np.float32)).to(dev)


GRAPHS = {"square": {}, "rectangular": dict(n_rows=3001, n_cols=5003)}


# each function's launches, by C entry
LAUNCHES = {"edge_scores": ("edge_scores",),
            "edge_softmax": ("edge_softmax",),
            "edge_softmax_grad": ("edge_softmax_grad",),
            "edge_scores_grad": ("edge_scores_grad_dst",
                                 "edge_scores_grad_src")}


def counted(entry: str) -> int:
    name = f"launch.{entry}"
    return profiling.read_counts([name])[name]


def check(fn: str, *args):
    """``es.<fn>`` on the card gives its plain version's bits, twice, and
    counts each of its launches once a call."""
    before = {e: counted(e) for e in LAUNCHES[fn]}
    got = getattr(es, fn)(*args)
    again = getattr(es, fn)(*args)
    want = getattr(es, fn + "_plain")(*args)
    torch.cuda.synchronize()
    assert {e: counted(e) - before[e] for e in before} == {
        e: 2 for e in before}
    many = isinstance(got, tuple)
    for a, b, c in zip(*(x if many else (x,) for x in (got, again, want))):
        assert torch.equal(a, b)
        assert torch.equal(a, c), (fn, int((a != c).sum()), a.numel())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GRAPHS))
def test_cuda_edge_scores_match_plain(cuda, shape):
    g = skewed_graph(cuda, **GRAPHS[shape])
    dst, src = node_scores(g.n_rows, 1, cuda), node_scores(g.n_cols, 2, cuda)
    logits, mask = check("edge_scores", g, dst, src, SLOPE)
    pre = (dst[g.rows.long()] + src[g.cols.long()])[: g.nnz]
    assert (pre == 0).any() and (pre > 0).any() and (pre < 0).any()
    assert logits.shape == mask.shape == (g.n_edges_padded,)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GRAPHS))
@pytest.mark.parametrize("logits", ["scores", "wide"])
def test_cuda_edge_softmax_and_grad_match_plain(cuda, shape, logits):
    """Logits from the scores, and normal draws at 20x scale (rows whose
    exponentials underflow but at their max)."""
    g = skewed_graph(cuda, **GRAPHS[shape])
    if logits == "scores":
        lg, _ = es.edge_scores(g, node_scores(g.n_rows, 3, cuda),
                               node_scores(g.n_cols, 4, cuda), SLOPE)
    else:
        gen = torch.Generator(device=cuda).manual_seed(5)
        lg = 20 * torch.randn(g.n_edges_padded, device=cuda, generator=gen)
    alpha = check("edge_softmax", g, lg)
    assert not alpha[g.nnz:].any()
    sums = row_sums(g, alpha)
    has_edge = torch.diff(g.row_ptr) > 0
    assert torch.allclose(sums[has_edge], torch.ones_like(sums[has_edge]),
                          atol=1e-5)
    assert not sums[~has_edge].any()
    gen = torch.Generator(device=cuda).manual_seed(6)
    gr = torch.randn(g.n_edges_padded, device=cuda, generator=gen)
    gr[g.nnz:] = 0.0
    d = check("edge_softmax_grad", g, alpha, gr)
    assert not d[g.nnz:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GRAPHS))
def test_cuda_edge_scores_grads_match_plain(cuda, shape):
    """Both sums of the scores' backward, and the row sums alone; the
    gradient on the padding slots is drawn too, and must not count."""
    g = skewed_graph(cuda, **GRAPHS[shape])
    _, mask = es.edge_scores(g, node_scores(g.n_rows, 7, cuda),
                             node_scores(g.n_cols, 8, cuda), SLOPE)
    gen = torch.Generator(device=cuda).manual_seed(9)
    d = torch.randn(g.n_edges_padded, device=cuda, generator=gen)
    places = transpose_places(g)
    d_dst, d_src = check("edge_scores_grad", g, d, mask, SLOPE, places)
    assert d_dst.shape == (g.n_rows,) and d_src.shape == (g.n_cols,)
    before = counted("edge_scores_grad_src")
    alone, none = es.edge_scores_grad(g, d, mask, SLOPE)
    assert none is None and torch.equal(alone, d_dst)
    assert counted("edge_scores_grad_src") == before
    d[g.nnz:] = 1e6
    assert all(torch.equal(a, b) for a, b in zip(
        es.edge_scores_grad(g, d, mask, SLOPE, places), (d_dst, d_src)))


def _gat_run(g, x, seeds, heads, dev):
    """A two-layer ``multi_head_gat`` (concat with ELU, then the heads'
    mean) and its backward from a cross-entropy: the output, each head's
    logits and attention values, and the gradients of x and every leaf."""
    l1 = port_gat.init_multi_head(torch.Generator().manual_seed(seeds[0]),
                                  heads[0], x.shape[1], 8, device=dev)
    l2 = port_gat.init_multi_head(torch.Generator().manual_seed(seeds[1]),
                                  heads[1], heads[0] * 8, 5, device=dev)
    x = x.clone().requires_grad_(True)
    seen = []
    real = port_gat.segment_softmax

    def spy(logits, graph):
        alpha = real(logits, graph)
        seen.extend([logits.detach().clone(), alpha.detach().clone()])
        return alpha

    port_gat.segment_softmax = spy
    try:
        h = port_gat.multi_head_gat(l1, x, g)
        out = port_gat.multi_head_gat(l2, h, g, concat=False,
                                      activation=None)
        y = torch.arange(g.n_rows, device=dev) % 5
        torch.nn.functional.cross_entropy(out, y).backward()
    finally:
        port_gat.segment_softmax = real
    leaves = [x] + list(l1.parameters()) + list(l2.parameters())
    return [out.detach()] + seen + [t.grad for t in leaves]


@pytest.mark.cuda
def test_cuda_multi_head_gat_gives_the_composition_bits(cuda, monkeypatch):
    g = skewed_graph(cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((g.n_rows, 24), device=cuda, generator=gen)
    heads = (4, 3)
    before = {e: counted(e) for e in es.ENTRIES}
    got = _gat_run(g, x, (3, 4), heads, cuda)
    again = _gat_run(g, x, (3, 4), heads, cuda)
    torch.cuda.synchronize()
    assert {e: counted(e) - before[e] for e in es.ENTRIES} == {
        e: 2 * sum(heads) for e in es.ENTRIES}
    for name in LAUNCHES:
        monkeypatch.setattr(es, name, getattr(es, name + "_plain"))
    want = _gat_run(g, x, (3, 4), heads, cuda)
    assert len(got) == len(want) == 1 + 2 * sum(heads) + 9
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        assert torch.equal(a, c), (i, int((a != c).sum()), a.numel())
