"""Generate a Graphviz diagram of a v1 model config (reference:
python/paddle/utils/make_model_diagram.py — proto config → dot).

usage: python -m paddle_tpu_torch.utils.make_model_diagram CONFIG_FILE [OUT.dot]
"""

import sys


def make_diagram(config_path: str, dot_path: str = None,
                 config_args: str = "") -> str:
    """Parse the v1 config and return (and optionally write) a dot
    graph over its captured layers."""
    from paddle_tpu_torch.trainer.config_parser import parse_config

    conf = parse_config(config_path, config_args)
    lines = ["digraph model {", "  rankdir=BT;"]
    for layer in conf.model_config.layers:
        name, type_ = layer["name"], layer.get("type", "?")
        size = layer.get("size")
        label = f"{name}\\n{type_}" + (f" [{size}]" if size else "")
        shape = "box" if type_ == "data" else "ellipse"
        lines.append(f'  "{name}" [label="{label}", shape={shape}];')
        for src in layer.get("inputs", []):
            lines.append(f'  "{src}" -> "{name}";')
    lines.append("}")
    dot = "\n".join(lines)
    if dot_path:
        with open(dot_path, "w") as f:
            f.write(dot)
    return dot


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    dot = make_diagram(argv[0], argv[1] if len(argv) > 1 else None)
    if len(argv) < 2:
        print(dot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
