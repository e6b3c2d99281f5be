"""The v1 trainer (``paddle_tpu/trainer/``): ``config_parser.parse_config``,
``PyDataProvider2``, ``trainer.Trainer`` and ``train_from_config``, and
the ``python -m paddle_tpu_torch.trainer`` command line."""

from paddle_tpu_torch.trainer.trainer import (Trainer, main,  # noqa: F401
                                              train_from_config)
