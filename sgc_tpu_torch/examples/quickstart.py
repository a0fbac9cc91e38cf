"""sgc_tpu_torch quickstart: runs end to end on synthetic data, no
downloads (the counterpart of examples/quickstart.py).

    python -m sgc_tpu_torch.examples.quickstart [--device cuda|cpu]

Builds a two-cluster graph, propagates features (SGC and APPNP), trains
the linear head, evaluates, runs the same training through the sharded
fit on a world of one rank, finds the two communities from shuffled ids,
fits a weight-decay grid at once, and serves predictions through the
inference engine. ``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sp
import torch


def make_toy_graph(n=400, seed=0):
    """Two communities; labels = community; features = noisy labels."""
    rng = np.random.default_rng(seed)
    half = n // 2
    labels = np.repeat([0, 1], half).astype(np.int32)
    r, c = np.triu_indices(n, 1)
    same = (r < half) == (c < half)
    keep = rng.random(len(r)) < np.where(same, 0.05, 0.002)
    adj = sp.coo_matrix(
        (np.ones(keep.sum(), np.float32), (r[keep], c[keep])), shape=(n, n)
    )
    adj = (adj + adj.T).tocsr()
    x = rng.standard_normal((n, 16)).astype(np.float32)
    x[:, 0] += labels * 1.5
    idx = rng.permutation(n)
    return adj, x, labels, np.sort(idx[: n // 2]), np.sort(idx[n // 2:])


def main(argv=None) -> int:
    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply
    from sgc_tpu_torch.ops.propagate import propagate_appnp, sgc_precompute
    from sgc_tpu_torch.train.loops import train_regression
    from sgc_tpu_torch.train.metrics import accuracy
    from sgc_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"backend: {dev.type}, devices: {n_dev}")

    adj, x_np, y, idx_train, idx_test = make_toy_graph()
    host_graph = SparseGraph.from_scipy(aug_normalized_adjacency(adj))
    graph = host_graph.to(dev)
    x = torch.as_tensor(x_np, device=dev)
    y_t = torch.as_tensor(y, device=dev).long()
    tr_idx = torch.as_tensor(idx_train, device=dev)
    te_idx = torch.as_tensor(idx_test, device=dev)

    # --- 1. SGC: propagate once, train the linear head -------------------
    feats, t_pre = sgc_precompute(x, graph, degree=2)
    params = init_sgc(torch.Generator().manual_seed(0), feats.shape[1], 2,
                      device=dev)
    params, t_train = train_regression(
        params, feats[tr_idx], y_t[tr_idx], epochs=100, lr=0.2,
        weight_decay=1e-5,
    )
    acc = accuracy(sgc_apply(params, feats[te_idx]), y_t[te_idx])
    print(f"SGC   K=2 : test acc {acc:.3f} "
          f"(precompute {t_pre:.3f}s, train {t_train:.3f}s)")

    # --- 2. APPNP: deep propagation without oversmoothing ----------------
    feats16 = propagate_appnp(x, graph, 16, alpha=0.1)
    p2 = init_sgc(torch.Generator().manual_seed(0), feats16.shape[1], 2,
                  device=dev)
    p2, _ = train_regression(p2, feats16[tr_idx], y_t[tr_idx], epochs=100)
    acc16 = accuracy(sgc_apply(p2, feats16[te_idx]), y_t[te_idx])
    print(f"APPNP K=16: test acc {acc16:.3f}")

    # --- 3. distributed: the same fit through the sharded path, on a ----
    # world of one rank (every card of a world when one is launched)
    from sgc_tpu_torch.parallel.fit import fit_sharded
    from sgc_tpu_torch.parallel.mesh import make_mesh

    _, report = fit_sharded(
        host_graph, x_np, y, idx_train, 2, degree=2, epochs=60,
        mesh=make_mesh(1, 1, device=dev),
    )
    print(f"sharded: {report.n_parts} parts, "
          f"halo {report.halo_fraction:.1%}, "
          f"train acc {report.train_accuracy:.3f}")

    # --- 3c. locality pipeline: discover communities, matmul the dense --
    from sgc_tpu_torch.graph.locality import LocalityPlan

    # shuffle node ids so LPA has to FIND the two communities
    rng = np.random.default_rng(1)
    perm = rng.permutation(adj.shape[0])        # perm[old] = new id
    inv = np.argsort(perm)                      # inv[new] = old id
    adj_s = adj[inv][:, inv]                    # row new <- old inv[new]
    g_s = SparseGraph.from_scipy(aug_normalized_adjacency(adj_s))
    plan = LocalityPlan.build(
        g_s, x_np[inv], y[inv], np.sort(perm[idx_train]),
        row_block=128, stripe=128, device=dev)
    print(f"locality: {plan.split_main.n_cells} dense cells discovered "
          f"from shuffled ids (dense frac {plan.dense_fraction:.0%})")

    # --- 3b. precompute-once, many heads: a wd grid in ONE program -------
    from sgc_tpu_torch.train.loops import train_regression_many

    wds = np.logspace(-8, -3, 8)
    many, _, dt = train_regression_many(
        init_sgc(torch.Generator().manual_seed(0), feats.shape[1], 2,
                 device=dev),
        feats[tr_idx], y_t[tr_idx], wds, epochs=60,
    )
    accs = [accuracy(sgc_apply(h, feats[te_idx]), y_t[te_idx]) for h in many]
    print(f"wd grid (8 heads, one batched program, {dt:.2f}s): "
          f"best test acc {max(accs):.3f}")

    # --- 4. serving -------------------------------------------------------
    from sgc_tpu_torch.serve import EngineConfig, InferenceEngine

    engine = InferenceEngine(
        params, features=feats.cpu().numpy(),
        config=EngineConfig(min_batch=8, max_batch=64), device=dev,
    )
    preds = engine.predict(list(idx_test[:10]))
    print(f"served predictions for 10 nodes: {preds.tolist()} "
          f"(mean latency {engine.stats.mean_latency_ms:.2f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
