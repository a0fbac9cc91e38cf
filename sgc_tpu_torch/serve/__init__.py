"""Serving: batched inference for trained SGC heads (the counterpart of
sgc_tpu/serve/).

  engine.py: InferenceEngine, shape-bucketed batch forward over a
             precomputed store (transductive, f32 or int8) or sampled
             neighborhoods (inductive), pipelined dispatch, latency stats.
  http.py:   a stdlib HTTP JSON endpoint around an engine.
"""

from sgc_tpu_torch.serve.engine import EngineConfig, InferenceEngine  # noqa: F401
