"""Models: the SGC head, the two-layer GCN, the deep GCN stack, GCNII, the
GAT layers and the transformer sequence classifier (the reference's
``models`` exports)."""

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
from sgc_tpu_torch.models.gcnii import (  # noqa: F401
    GCNII,
    gcnii_apply,
    init_gcnii,
    scaled_operator,
)
from sgc_tpu_torch.models.registry import (  # noqa: F401
    get_model,
    register_model,
)
from sgc_tpu_torch.models.sgc import SGC, init_sgc, sgc_apply  # noqa: F401
from sgc_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    init_transformer,
    transformer_apply,
)

__all__ = [
    "SGC", "init_sgc", "sgc_apply",
    "GCN", "init_gcn", "gcn_apply",
    "GCNII", "init_gcnii", "gcnii_apply", "scaled_operator",
    "get_model", "register_model",
    "DeepGCN", "deep_gcn_apply", "init_deep_gcn", "stage_layers",
    "GATLayer", "gat_layer_apply", "init_gat_layer", "init_multi_head",
    "multi_head_gat",
    "Transformer", "TransformerConfig", "init_transformer",
    "transformer_apply",
]
