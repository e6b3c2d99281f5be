"""Config-parse entry points
(``paddle_tpu/trainer_config_helpers/config_parser_utils.py``): the thin
functions over ``paddle_tpu_torch.trainer.config_parser``."""

__all__ = [
    "parse_trainer_config", "parse_network_config",
    "parse_optimizer_config", "reset_parser",
]


def parse_trainer_config(trainer_conf, config_arg_str=""):
    from paddle_tpu_torch.trainer import config_parser

    return config_parser.parse_config(trainer_conf, config_arg_str)


def parse_network_config(network_conf, config_arg_str=""):
    """The proto-shaped ModelConfigView of the parsed config."""
    from paddle_tpu_torch.trainer import config_parser

    return config_parser.parse_config(network_conf,
                                      config_arg_str).model_config


def parse_optimizer_config(optimizer_conf, config_arg_str=""):
    """Run a callable that declares ``settings(...)`` and return the
    captured optimization settings dict."""
    from paddle_tpu_torch.trainer import config_parser

    def conf():
        optimizer_conf()

    return config_parser.parse_config(conf, config_arg_str).opt_config


def reset_parser():
    """Clear the parser's program state between config parses."""
    from paddle_tpu_torch import framework

    framework.reset_default_programs()
