"""The port's ``utils/`` tools against the JAX package's on the CPU: each
tool's output on the same input equal to the reference tool's (text
exactly, arrays exactly).  One child process runs ``python -m
paddle_tpu_torch.utils.dump_config``; the rest are called in process.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from test_torch_demos import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = (
    "from {pkg}.trainer_config_helpers import *\n"
    "settings(batch_size=16, learning_rate=0.1)\n"
    "x = data_layer(name='x', size=6)\n"
    "lab = data_layer(name='lab', size=3)\n"
    "hid = fc_layer(input=x, size=5, act=TanhActivation())\n"
    "pred = fc_layer(input=hid, size=3, act=SoftmaxActivation())\n"
    "outputs(classification_cost(input=pred, label=lab))\n")


def _tool(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.utils.{name}")


@pytest.fixture
def configs(tmp_path):
    paths = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        p = tmp_path / f"conf_{pkg}.py"
        p.write_text(CONFIG.format(pkg=pkg))
        paths[pkg] = str(p)
    return paths


def test_dump_config_and_make_model_diagram(configs, tmp_path):
    """The captured config as JSON and its dot graph, equal to the JAX
    tools'; the python -m entry prints the same JSON."""
    import importlib

    outs = {}
    for pkg, path in configs.items():
        fl = fluid if pkg == "paddle_tpu" else pt
        fl.framework.reset_default_programs()
        # the layers' names count from here, as in a fresh process
        counter = importlib.import_module(f"{pkg}.v2.layer")._counter
        counter[0] = 0
        dumped = _tool(pkg, "dump_config").dump_config(path)
        counter[0] = 0
        outs[pkg] = (dumped, _tool(pkg, "make_model_diagram").make_diagram(
            path, str(tmp_path / f"{pkg}.dot")))
    # a settings object (the learning method) compares by its class name
    def plain(d):
        return json.dumps(d, default=lambda o: type(o).__name__)

    assert plain(outs["paddle_tpu_torch"][0]) == plain(outs["paddle_tpu"][0])
    assert outs["paddle_tpu_torch"][1] == outs["paddle_tpu"][1]
    assert (tmp_path / "paddle_tpu_torch.dot").read_text() == \
        outs["paddle_tpu"][1]
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.utils.dump_config",
         configs["paddle_tpu_torch"]], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["layers"] == json.loads(plain(
        outs["paddle_tpu"][0]))["layers"]


LOG = """Pass 0, Batch 0, Cost 1.250000, Eval: classification_error=0.5
Pass 0, Batch 1, Cost 0.875000, Eval: classification_error=0.25
Test done in 0.1s, cost 0.700000
Pass=1 Batch=10 AvgCost=0.5 Eval: err=0.1
"""


@pytest.mark.parametrize("keys", [[], ["AvgCost"]])
def test_plotcurve(tmp_path, capsys, keys):
    """The parsed series, the text summary and the figure."""
    lines = LOG.splitlines(True)
    got = _tool("paddle_tpu_torch", "plotcurve").parse_log(lines, keys)
    assert got == _tool("paddle_tpu", "plotcurve").parse_log(lines, keys)
    log = tmp_path / "train.log"
    log.write_text(LOG)
    outs = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        assert _tool(pkg, "plotcurve").main(["-i", str(log), *keys]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and "Cost: n=2" in outs[1]
    png = tmp_path / "curve.png"
    _tool("paddle_tpu_torch", "plotcurve").main(["-i", str(log), "-o",
                                                 str(png)])
    assert png.read_bytes()[:4] == b"\x89PNG"


def test_show_pb_and_merge_model(configs, tmp_path, capsys):
    """show_pb over a merged export, and the utils' merge_model entry
    (the command line's), equal to the JAX tools' on the same params.tar."""
    pt.framework.reset_default_programs()
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer

    t = Trainer(parse_config(configs["paddle_tpu_torch"]), pt.CPUPlace())
    model_dir = tmp_path / "m"
    (model_dir / "pass-00000").mkdir(parents=True)
    with open(model_dir / "pass-00000" / "params.tar", "wb") as f:
        t.parameters.to_tar(f)
    outs = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        fl = fluid if pkg == "paddle_tpu" else pt
        fl.framework.reset_default_programs()
        out = tmp_path / pkg
        args = [f"--model_dir={model_dir}", f"--out={out}",
                f"--config={configs[pkg]}"]
        if pkg == "paddle_tpu_torch":
            args.append("--use_gpu=0")
        assert _tool(pkg, "merge_model").main(args) == 0
        capsys.readouterr()
        buf = io.StringIO()
        info = _tool(pkg, "show_pb").show(str(out), out=buf)
        outs.append((info, buf.getvalue()))
        assert _tool(pkg, "show_pb").main([str(out / "__model__.json")]) == 0
        assert capsys.readouterr().out == buf.getvalue()
    assert outs[1] == outs[0]
    assert "feeds: ['x']" in outs[1][1]


def test_torch2paddle_writes_the_jax_tar(tmp_path):
    """A state_dict through a name map into the Parameters tar: the same
    members and arrays as the JAX tool's, readable by the port's
    Parameters.load_tar layout."""
    lin = torch.nn.Linear(4, 3)
    sd = lin.state_dict()
    name_map = {"fc_0.w_0": "weight", "fc_0.b_0": "bias"}
    tars = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        buf = io.BytesIO()
        _tool(pkg, "torch2paddle").state_dict_to_tar(sd, buf, name_map)
        buf.seek(0)
        with tarfile.open(fileobj=buf) as tar:
            tars.append({m.name: np.load(io.BytesIO(
                tar.extractfile(m).read())) for m in tar.getmembers()})
    assert sorted(tars[1]) == sorted(tars[0]) == ["fc_0.b_0.npy",
                                                  "fc_0.w_0.npy"]
    for k in tars[0]:
        np.testing.assert_array_equal(tars[1][k], tars[0][k])
    np.testing.assert_array_equal(tars[1]["fc_0.w_0.npy"],
                                  sd["weight"].numpy().T)
    ckpt = tmp_path / "ck.pt"
    torch.save(sd, ckpt)
    assert _tool("paddle_tpu_torch", "torch2paddle").main(
        [str(ckpt), str(tmp_path / "o.tar"), "w=weight"]) == 0


def test_predefined_nets_are_the_ports_models():
    pmod = _tool("paddle_tpu_torch", "predefined_net")
    jmod = _tool("paddle_tpu", "predefined_net")
    assert sorted(pmod.predefined_nets()) == sorted(jmod.predefined_nets())
    for name, fn in pmod.predefined_nets().items():
        assert fn.__module__.startswith("paddle_tpu_torch.models"), name
    with pytest.raises(KeyError, match="unknown predefined net"):
        pmod.get_predefined_net("nope")


def test_image_tools(tmp_path):
    """image_util, preprocess_util / preprocess_img and image_multiproc:
    the same arrays, batch files and mean image as the JAX tools'."""
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (20, 30, 3)).astype(np.uint8)
    pu = _tool("paddle_tpu_torch", "image_util")
    ju = _tool("paddle_tpu", "image_util")
    np.testing.assert_array_equal(pu.resize_image(img, 12),
                                  ju.resize_image(img, 12))
    np.testing.assert_array_equal(pu.oversample(img, 8), ju.oversample(img, 8))
    np.testing.assert_array_equal(pu.crop_img(img, 10), ju.crop_img(img, 10))
    mean = np.zeros((3, 10, 10), np.float32)
    np.testing.assert_array_equal(
        pu.preprocess_img(img, mean, 10, is_train=False),
        ju.preprocess_img(img, mean, 10, is_train=False))
    for label in ("cat", "dog"):
        d = tmp_path / "data" / label
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (16, 16, 3)).astype(
                np.uint8)).save(d / f"{i}.png")
    made = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        out = tmp_path / f"out_{pkg}"
        c = _tool(pkg, "preprocess_img").ImageClassificationDatasetCreater(
            str(tmp_path / "data"), target_size=8, batch_size=4,
            test_ratio=0.34)
        train, test = c.create(str(out))
        made.append(([_tool(pkg, "preprocess_util").load_batch(f)
                      for f in train + test],
                     np.load(out / "meta.npz")["mean"],
                     (out / "labels.txt").read_text()))
    (jb, jm, jl), (pb, pm, pl) = made
    assert pl == jl
    np.testing.assert_array_equal(pm, jm)
    for (pd, plab), (jd, jlab) in zip(pb, jb):
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(plab, jlab)
    samples = [(rng.randint(0, 255, (14, 18, 3)).astype(np.uint8), i)
               for i in range(5)]
    got = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        mp = _tool(pkg, "image_multiproc")
        tf = mp.PixelTransformer(12, 10, is_train=False)
        got.append(list(mp.multiproc_reader(lambda: iter(samples), tf,
                                            workers=2, order=True)()))
    for (pa, pl_), (ja, jl_) in zip(got[1], got[0]):
        np.testing.assert_array_equal(pa, ja)
        assert pl_ == jl_
