"""Inspect a saved model directory (reference:
python/paddle/utils/show_pb.py — printed the binary ModelConfig proto;
here models persist as ``__model__.json`` + per-parameter ``.npz``, so
the tool prints the program summary and the parameter manifest).

usage: python -m paddle_tpu_torch.utils.show_pb MODEL_DIR_OR_JSON
"""

import json
import os
import sys


def show(path: str, out=None) -> dict:
    out = out or sys.stdout
    model_json = (os.path.join(path, "__model__.json")
                  if os.path.isdir(path) else path)
    with open(model_json) as f:
        d = json.load(f)
    prog = d.get("program", d)
    info = {
        "feed_names": d.get("feed_names", []),
        "fetch_names": d.get("fetch_names", []),
        "blocks": [],
    }
    for b in prog.get("blocks", []):
        ops = [op.get("type") for op in b.get("ops", [])]
        bvars = b.get("vars", {})
        bvars = bvars.values() if isinstance(bvars, dict) else bvars
        params = [v.get("name") for v in bvars
                  if v.get("is_parameter") or v.get("persistable")]
        info["blocks"].append({"idx": b.get("idx", 0), "n_ops": len(ops),
                               "op_types": ops, "persistables": params})
    print(f"feeds: {info['feed_names']}", file=out)
    print(f"fetches: {info['fetch_names']}", file=out)
    for b in info["blocks"]:
        print(f"block {b['idx']}: {b['n_ops']} ops", file=out)
        for t in b["op_types"]:
            print(f"  {t}", file=out)
        if b["persistables"]:
            print(f"  persistables: {', '.join(b['persistables'])}",
                  file=out)
    return info


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    show(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
