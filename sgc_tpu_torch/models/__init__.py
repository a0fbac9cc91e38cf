"""Models: the SGC head, the two-layer GCN, the deep GCN stack and the
GAT layers (the reference's ``models`` exports, but for the transformer,
which is not ported yet: ROADMAP queue 1 item 3)."""

from sgc_tpu_torch.models.deep_gcn import (  # noqa: F401
    DeepGCN,
    deep_gcn_apply,
    init_deep_gcn,
    stage_layers,
)
from sgc_tpu_torch.models.gat import (  # noqa: F401
    GATLayer,
    gat_layer_apply,
    init_gat_layer,
    init_multi_head,
    multi_head_gat,
)
from sgc_tpu_torch.models.gcn import GCN, gcn_apply, init_gcn  # noqa: F401
from sgc_tpu_torch.models.registry import (  # noqa: F401
    get_model,
    register_model,
)
from sgc_tpu_torch.models.sgc import SGC, init_sgc, sgc_apply  # noqa: F401

__all__ = [
    "SGC", "init_sgc", "sgc_apply",
    "GCN", "init_gcn", "gcn_apply",
    "get_model", "register_model",
    "DeepGCN", "deep_gcn_apply", "init_deep_gcn", "stage_layers",
    "GATLayer", "gat_layer_apply", "init_gat_layer", "init_multi_head",
    "multi_head_gat",
]
