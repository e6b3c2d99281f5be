"""The v1 trainer (``paddle_tpu/trainer/``): ``config_parser.parse_config``
and ``trainer.Trainer``."""
