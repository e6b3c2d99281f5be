"""The v2 evaluators (``paddle_tpu/v2/evaluator.py``): every
``trainer_config_helpers`` ``*_evaluator`` under its name without the
suffix (``paddle.evaluator.auc``, ...)."""

import paddle_tpu_torch.trainer_config_helpers.evaluators as _evs

__all__ = []

for _name in _evs.__all__:
    if _name.endswith("_evaluator"):
        _new = _name[:-len("_evaluator")]
        globals()[_new] = getattr(_evs, _name)
        __all__.append(_new)

del _name, _new
