"""Hyperparameter search over frozen propagated features (the
counterpart of sgc_tpu/tune): propagate once, then search the weight
decay with cheap head fits (cli/tuning.py); ``tpe.py`` is the
Tree-structured Parzen Estimator."""

from sgc_tpu_torch.tune.tpe import TPESampler, fmin  # noqa: F401
