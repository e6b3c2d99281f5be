"""Merge a trained model dir (config + per-pass parameters) into one
deployable inference-model directory (reference:
python/paddle/utils/merge_model.py — fused config proto + params into a
single binary for the C API; here the output is the
``save_inference_model`` layout the C API consumes).

usage: python -m paddle_tpu_torch.utils.merge_model --model_dir=DIR --out=OUT
"""

import sys


def merge_v2_model(config_path: str, model_dir: str, out_dir: str,
                   config_args: str = "", place=None):
    """Parse ``config_path``, load parameters from ``model_dir`` on
    ``place`` (``CUDAPlace(0)`` unless given), write the merged
    inference model to ``out_dir``."""
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer

    conf = parse_config(config_path, config_args)
    t = Trainer(conf, place)
    t.load_parameters(model_dir)
    t.export_inference_model(out_dir)
    return out_dir


def main(argv=None):
    from paddle_tpu_torch.cli import cmd_merge_model

    return cmd_merge_model(list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
