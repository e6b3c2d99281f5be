"""Convert a PyTorch checkpoint into a v2 Parameters tar (reference:
python/paddle/utils/torch2paddle.py — lua-torch t7 → paddle tar; the
modern equivalent maps a ``state_dict`` (or ``.pt`` file) through a
name map into the Parameters tar layout v2 reads with
``parameters.init_from_tar``).

usage: python -m paddle_tpu_torch.utils.torch2paddle CKPT.pt OUT.tar [name=torch_name ...]
"""

import sys

import numpy as np


def state_dict_to_tar(state_dict, f, name_map=None, transpose_linear=True):
    """Write ``state_dict`` into the v2 Parameters tar format (the one
    definition of that format is parameters.write_npy_tar).

    ``name_map``: {paddle_name: torch_name}; default keeps torch names.
    ``transpose_linear``: torch nn.Linear stores (out, in); paddle fc
    weights are (in, out) — 2-D tensors whose key ends in ``weight``
    are transposed.
    """
    from paddle_tpu_torch.v2.parameters import write_npy_tar

    items = (name_map.items() if name_map
             else [(k, k) for k in state_dict])

    def rows():
        for pname, tname in items:
            t = state_dict[tname]
            arr = np.asarray(t.detach().cpu().numpy()
                             if hasattr(t, "detach") else t)
            if (transpose_linear and arr.ndim == 2
                    and tname.endswith("weight")):
                arr = arr.T
            yield pname, arr

    write_npy_tar(rows(), f)


def convert(ckpt_path: str, out_tar: str, name_map=None):
    import torch

    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    with open(out_tar, "wb") as f:
        state_dict_to_tar(sd, f, name_map)
    return out_tar


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    name_map = dict(kv.split("=", 1) for kv in argv[2:]) or None
    convert(argv[0], argv[1], name_map)
    return 0


if __name__ == "__main__":
    sys.exit(main())
