"""Distributed execution on ``torch.distributed`` (the counterpart of
sgc_tpu/parallel/): meshes of ranks, graph partitioning, sharded SpMM.

Each rank is a process with its own device; it calls every sharded
function with its own tile (``x_local`` ``[rows_per_part, F / n_feat]``)
and gets its tile back. Host plans are numpy, built once and read by
every rank (each reads its own part).

  mesh.py        ("nodes", "feat") meshes of ranks; their collectives
                 over a named transport (NCCL, or gloo through pinned
                 host memory)
  partition.py   row-block edge partitioning of a SparseGraph
  halo.py        the boundary-row all_to_all plan and its hops
                 (kernel B)
  blockdense.py  the sharded block-dense plan and its hop (kernels A, B)
  spmm.py        spmm_sharded / propagate_sharded over every plan
  train.py       the sharded SGC train step (Adam)
  debug.py       checksum exchange validation, fault injection,
                 determinism assertions
  scaling.py     init_distributed, the host-only comm models, the
                 edges/s scaling harness
  distributed.py put_global / fetch_global and the rank launcher
  bodies.py      rank bodies the CPU tests and the chip smoke spawn

Not ported yet: ``fit``, ``gcn``, ``inductive`` and ``staging`` (the
sharded fit, GCN and inductive paths, host staging; ROADMAP queue 1).
"""

from sgc_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from sgc_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedGraph,
    partition_graph,
)
from sgc_tpu_torch.parallel.spmm import spmm_sharded  # noqa: F401
from sgc_tpu_torch.parallel.halo import build_halo  # noqa: F401
from sgc_tpu_torch.parallel.debug import (  # noqa: F401
    assert_deterministic,
    validate_exchange,
)
from sgc_tpu_torch.parallel.scaling import (  # noqa: F401
    init_distributed,
    measure_spmm_scaling,
)
from sgc_tpu_torch.parallel.distributed import (  # noqa: F401
    fetch_global,
    put_global,
)
