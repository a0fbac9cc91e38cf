"""GCNII on the card: the model through kernel B with its initial
residual fused in, held against the plain reference
(``tests/gcnii_reference.py``, float64 on the host) at a medium size;
the same bits over two runs; 128 kernel-B launches a step at 64 layers,
64 of them adding the dense operand and 64 over the transpose.

Tolerances, relative to the reference's largest entry: the first logits,
loss and gradients as in the CPU file (tests/test_torch_port_gcnii.py).
After 3 Adam steps each leaf's change is compared by its norm, as the
benchmark's ``change_gap`` compares it, within 1e-4 of the larger of
that leaf's and the median leaf's reference norm: element by element,
Adam's first steps move an element by ``lr g / (|g| + eps)``, which for
the few elements whose gradient is within a few ``eps`` of 0 turns a
float32 rounding of ``g`` into a change of up to a few parts in 10^3 of
the largest (1.2e-3 on this problem on the card; the full-size cell's
``change_gap`` read 4.4e-8 to 6.2e-6 over 12 seeds).

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the reference package, so on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_gcnii_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import gcnii as port_gcnii
from sgc_tpu_torch.ops.spmm import spmm, spmm_segment_plain
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.utils import profiling
import gcnii_reference as ref

# the CPU file's tolerances (tests/test_torch_port_gcnii.py): kernel B
# sums each row in its own order, as the plain version does in another
TOL = {"logits": 2e-6, "loss": 1e-6, "grad": 2e-6, "change": 1e-4}
SETTING = dict(alpha=0.1, lamda=0.5, lr=0.01, wd_conv=0.01, wd_dense=5e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def problem(dev, seed=0, n=20000, e=200000, f=64, c=8, layers=16,
            hidden=64):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    adj = sp.coo_matrix((np.ones(e, np.float32), (src, dst)), shape=(n, n))
    g = SparseGraph.from_scipy(aug_normalized_adjacency(adj + adj.T)).to(dev)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    idx = np.sort(rng.choice(n, n // 2, replace=False))

    def u(shape, fan):
        return torch.tensor(rng.uniform(-fan ** -0.5, fan ** -0.5, shape),
                            dtype=torch.float32)

    init = {"w_in": u((f, hidden), f), "b_in": u((hidden,), f),
            "w_conv": u((layers, hidden, hidden), hidden),
            "w_out": u((hidden, c), hidden), "b_out": u((c,), hidden)}
    return dict(src=src, dst=dst, n=n, g=g, x=x, y=y, idx=idx, init=init)


def model_of(init, dev):
    return port_gcnii.GCNII(*(init[k].clone().to(dev) for k in ref.LEAVES))


def rel(got, want) -> float:
    got = torch.as_tensor(got).detach().cpu().double()
    want = torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max())


def step(model, x, scaled, target):
    loss = port_loops.node_cross_entropy(
        port_gcnii.gcnii_apply(model, x, scaled, SETTING["alpha"],
                               SETTING["lamda"]), *target)
    loss.backward()
    return loss


def change_gap(fit, want, init) -> float:
    """The worst leaf's gap of change norms over the larger of its and
    the median leaf's reference norm (conv weights layer by layer)."""
    def norms(changes):
        out = []
        for k in ref.LEAVES:
            t = changes[k]
            out += [float(c.norm()) for c in (t.unbind(0) if k == "w_conv"
                                              else [t])]
        return out

    got = norms({k: getattr(fit, k).detach().cpu().double() - init[k]
                 for k in ref.LEAVES})
    ref_n = norms({k: want["params"][k] - init[k] for k in ref.LEAVES})
    med = float(np.median(ref_n))
    return max(abs(g - r) / max(r, med) for g, r in zip(got, ref_n))


@pytest.mark.cuda
def test_cuda_gcnii_matches_reference(cuda):
    p = problem(cuda)
    x = torch.from_numpy(p["x"]).to(cuda)
    yt = torch.as_tensor(p["y"][p["idx"]], device=cuda)
    model = model_of(p["init"], cuda)
    scaled = port_gcnii.scaled_operator(p["g"], SETTING["alpha"])
    logits = port_gcnii.gcnii_apply(model, x, scaled, SETTING["alpha"],
                                    SETTING["lamda"])
    target = port_loops.train_target(p["n"], p["idx"], yt)
    loss = port_loops.node_cross_entropy(logits, *target)
    loss.backward()
    fit, _ = port_loops.train_gcnii(model_of(p["init"], cuda), x, p["g"],
                                    p["idx"], yt, epochs=3, dropout=0.0,
                                    **SETTING)
    want = ref.train(p["init"], p["x"], p["src"], p["dst"], p["n"],
                     p["idx"], p["y"], steps=3, **SETTING)
    init = {k: v.double() for k, v in p["init"].items()}
    errs = {
        "logits": rel(logits, want["logits1"]),
        "loss": abs(float(loss.detach()) - want["losses"][0])
        / want["losses"][0],
        "grad": max(rel(getattr(model, k).grad, want["grad1"][k])
                    for k in ref.LEAVES),
        "change": change_gap(fit, want, init)}
    assert all(errs[k] <= TOL[k] for k in TOL), errs


@pytest.mark.cuda
def test_cuda_gcnii_training_repeats_its_bits(cuda):
    p = problem(cuda, n=8000, e=60000, layers=8)
    x = torch.from_numpy(p["x"]).to(cuda)
    yt = torch.as_tensor(p["y"][p["idx"]], device=cuda)
    runs = [port_loops.train_gcnii(model_of(p["init"], cuda), x, p["g"],
                                   p["idx"], yt, epochs=3, dropout=0.6,
                                   seed=11, **SETTING)[0]
            for _ in range(2)]
    for k in ref.LEAVES:
        assert torch.equal(getattr(runs[0], k), getattr(runs[1], k)), k


@pytest.mark.cuda
def test_cuda_gcnii_step_launch_counts(cuda):
    layers = 64
    p = problem(cuda, n=8000, e=60000, layers=layers)
    x = torch.from_numpy(p["x"]).to(cuda)
    target = port_loops.train_target(
        p["n"], p["idx"], torch.as_tensor(p["y"][p["idx"]], device=cuda))
    model = model_of(p["init"], cuda)
    scaled = port_gcnii.scaled_operator(p["g"], SETTING["alpha"])
    step(model, x, scaled, target)
    torch.cuda.synchronize()
    names = ("launch.csr_spmm", "within.csr_spmm_dense",
             "within.csr_spmm_transposed", "launch.sddmm")
    before = profiling.read_counts(names)
    step(model, x, scaled, target)
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in profiling.read_counts(names).items()}
    assert got == {"launch.csr_spmm": 2 * layers,
                   "within.csr_spmm_dense": layers,
                   "within.csr_spmm_transposed": layers, "launch.sddmm": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 41, 64])
def test_cuda_spmm_dense_against_plain(cuda, f):
    p = problem(cuda, n=12000, e=150000, f=f, layers=1)
    gen = torch.Generator().manual_seed(f)
    x = torch.randn(p["n"], f, generator=gen)
    d = torch.randn(p["n"], f, generator=gen)
    w = torch.randn(p["n"], f, generator=gen)
    xd, dd = (t.to(cuda).requires_grad_() for t in (x, d))
    out = spmm(p["g"], xd, dense=dd, span_name="test.dense")
    (out * w.to(cuda)).sum().backward()
    g_cpu = p["g"].to("cpu")
    want = spmm_segment_plain(g_cpu, x, d)
    gt = spmm_segment_plain(g_cpu.transpose(), w)
    assert rel(out, want) <= 1e-5
    assert rel(xd.grad, gt) <= 1e-5
    assert torch.equal(dd.grad.cpu(), w)
    again = spmm(p["g"], xd.detach(), dense=dd.detach())
    assert torch.equal(again, out.detach())
