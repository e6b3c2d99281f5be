"""Parse a v1 trainer config and dump the captured model config
(reference: python/paddle/utils/dump_config.py — printed the
TrainerConfig proto; here the proto-shaped view serializes as JSON).

usage: python -m paddle_tpu_torch.utils.dump_config CONFIG_FILE [config_args]
"""

import json
import sys


def dump_config(config_path: str, config_args: str = "") -> dict:
    from paddle_tpu_torch.trainer.config_parser import parse_config

    conf = parse_config(config_path, config_args)
    view = conf.model_config
    return {
        "layers": view.layers,
        "input_layer_names": list(view.input_layer_names),
        "output_layer_names": list(view.output_layer_names),
        "settings": conf.opt_config or {},
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    config_args = argv[1] if len(argv) > 1 else ""
    print(json.dumps(dump_config(argv[0], config_args), indent=2,
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
