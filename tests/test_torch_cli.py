"""The port's ``paddle`` command line (``python -m paddle_tpu_torch.cli``)
against the JAX package's (``paddle_tpu/cli.py``) on the CPU.

One child process runs ``python -m paddle_tpu_torch.cli train`` with
``--use_gpu=0``; every other command is called in process through
``cli.main``.  Checks: the train -> merge_model -> load round trip across
the two packages (a ``params.tar`` and an inference export written by
either load in the other: parameters equal exactly, outputs within 1e-5
of max), ``lint``'s diagnostics and optimizer reports equal to the JAX
command's on the same targets, ``stats`` over an artifact and a script,
``serve``'s flags (shared with ``python -m paddle_tpu_torch.serving``),
``version``, and the commands that wait for later steps.
"""

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import cli as jcli
from paddle_tpu_torch import cli
from test_torch_control_flow import close
from test_torch_demos import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

PROVIDER = (
    "import numpy as np\n"
    "def process(fname):\n"
    "    r = np.random.RandomState(0)\n"
    "    n = int(fname or 32)\n"
    "    for _ in range(n):\n"
    "        y = int(r.randint(0, 3))\n"
    "        x = np.zeros(6, np.float32); x[y*2:y*2+2] = 1.0\n"
    "        x += 0.1 * r.randn(6).astype(np.float32)\n"
    "        yield {'x': x, 'lab': y}\n")

CONFIG = (
    "from {pkg}.trainer_config_helpers import *\n"
    "define_py_data_sources2(train_list='48', test_list='24',\n"
    "                        module='cli_prov', obj='process')\n"
    "settings(batch_size=16, learning_rate=0.1)\n"
    "x = data_layer(name='x', size=6)\n"
    "lab = data_layer(name='lab', size=3)\n"
    "hid = fc_layer(input=x, size=5, act=TanhActivation())\n"
    "pred = fc_layer(input=hid, size=3, act=SoftmaxActivation())\n"
    "value_printer_evaluator(input=pred, name='vp')\n"
    "classification_error_evaluator(input=pred, label=lab)\n"
    "outputs(classification_cost(input=pred, label=lab))\n")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny v1 config (tests/test_cli.py:_tiny_config) for each
    package, with a printer and an evaluator, its provider importable."""
    (tmp_path / "cli_prov.py").write_text(PROVIDER)
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        (tmp_path / f"conf_{pkg}.py").write_text(CONFIG.format(pkg=pkg))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _load_export(fl, d):
    exe = fl.Executor(fl.CPUPlace())
    if fl is pt:
        scope = pt.Scope()
        prog, feeds, fetches = pt.io.load_inference_model(d, exe, scope=scope)
        return lambda x: exe.run(prog, feed={feeds[0]: x},
                                 fetch_list=fetches, scope=scope)
    prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
    return lambda x: exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)


def test_train_merge_model_and_load_across_packages(tiny, capsys):
    """paddle train (the port's in a child process, on the CPU; the JAX
    package's in process), then merge_model of each package's params.tar
    by each package: the exports' parameters equal exactly, their
    outputs within TOL of max, and each loads in the other package."""
    env = dict(os.environ, PYTHONPATH=str(tiny) + os.pathsep + REPO)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "train",
         f"--config={tiny / 'conf_paddle_tpu_torch.py'}", "--num_passes=1",
         "--log_period=1", f"--save_dir={tiny / 'p'}", "--use_gpu=0"],
        capture_output=True, text=True, env=env, cwd=str(tiny), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    batches = [ln for ln in out.stdout.splitlines() if ln.startswith("Pass ")]
    assert len(batches) == 3
    assert all("classification_error_evaluator=" in ln for ln in batches)
    assert out.stdout.count("[print vp:") == 3
    assert jcli.cmd_train([f"--config={tiny / 'conf_paddle_tpu.py'}",
                           "--num_passes=1",
                           f"--save_dir={tiny / 'j'}"]) == 0
    capsys.readouterr()
    exports = {}
    for tar in ("p", "j"):
        d = str(tiny / f"{tar}_by_port")
        assert cli.main(["merge_model", f"--model_dir={tiny / tar}",
                         f"--out={d}", "--use_gpu=0",
                         f"--config={tiny / 'conf_paddle_tpu_torch.py'}"]
                        ) == 0
        exports[tar, pt] = d
        d = str(tiny / f"{tar}_by_jax")
        assert jcli.cmd_merge_model([f"--model_dir={tiny / tar}",
                                     f"--out={d}",
                                     f"--config={tiny / 'conf_paddle_tpu.py'}"]
                                    ) == 0
        exports[tar, fluid] = d
    assert "merged model written to" in capsys.readouterr().out
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    for tar in ("p", "j"):
        pd, jd = exports[tar, pt], exports[tar, fluid]
        pnames = sorted(f for f in os.listdir(pd) if f.endswith(".npy"))
        assert pnames == sorted(f for f in os.listdir(jd)
                                if f.endswith(".npy"))
        for f in pnames:
            np.testing.assert_array_equal(np.load(os.path.join(pd, f)),
                                          np.load(os.path.join(jd, f)))
        want = _load_export(fluid, jd)(x)
        for fl, d in ((pt, pd), (pt, jd), (fluid, pd)):
            for g, w in zip(_load_export(fl, d)(x), want):
                close(np.asarray(g), np.asarray(w), TOL, f"{tar} {d}")


def _lint_json(mod, argv, capsys):
    rc = mod.main(["lint", *argv]) if mod is cli else mod.cmd_lint(argv)
    return rc, json.loads(capsys.readouterr().out)


FLUID_SCRIPT = (
    "import {pkg} as fl\n"
    "x = fl.layers.data(name='x', shape=[4])\n"
    "h = fl.layers.fc(input=x, size=3, act='relu')\n"
    "a = fl.layers.scale(h, scale=2.0)\n"
    "b = fl.layers.scale(h, scale=2.0)\n"
    "y = fl.layers.elementwise_add(a, b)\n"
    "loss = fl.layers.mean(y)\n")


def test_lint_reports_as_the_jax_command(tiny, capsys):
    """lint --json --optimize over a v1 config, a fluid script and an
    inference export: the diagnostics and the optimizer's reports equal
    the JAX command's; --audit-registry is clean on the port's baseline;
    a missing target exits 2."""
    fluid.framework.reset_default_programs()
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        (tiny / f"script_{pkg}.py").write_text(FLUID_SCRIPT.format(pkg=pkg))
    x = fluid.layers.data(name="x", shape=[4])
    pred = fluid.layers.fc(input=x, size=2, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    export = str(tiny / "export")
    fluid.io.save_inference_model(export, ["x"], [pred], exe)
    model = os.path.join(export, "__model__.json")
    for target, extra in (("conf", []), ("script", []), (None, [])):
        docs = []
        for mod, pkg in ((jcli, "paddle_tpu"), (cli, "paddle_tpu_torch")):
            fluid.framework.reset_default_programs()
            pt.framework.reset_default_programs()
            path = model if target is None else str(
                tiny / f"{target}_{pkg}.py")
            rc, doc = _lint_json(mod, [path, "--json", "--optimize",
                                       "--level=all", *extra], capsys)
            docs.append((rc, doc["diagnostics"],
                         list(doc["optimize"].values())))
        assert docs[1] == docs[0], target
        assert docs[1][0] == 0
    assert cli.main(["lint", "--audit-registry"]) == 0
    assert cli.main(["lint", str(tiny / "missing.json")]) == 2
    assert cli.main(["lint"]) == 2


def test_stats_as_the_jax_command(tiny, capsys):
    """stats --run of a fluid script on the CPU (--use_gpu=0: the
    script's Executor() with no place) records the Executor's families;
    --file renders an artifact as the JAX command does; --trace writes
    the host events."""
    from paddle_tpu_torch import observability as obs

    obs.reset()
    script = tiny / "run_me.py"
    script.write_text(
        "import numpy as np\n"
        "import paddle_tpu_torch as pt\n"
        "x = pt.layers.data(name='x', shape=[3])\n"
        "y = pt.layers.fc(input=x, size=2)\n"
        "exe = pt.Executor()\n"
        "exe.run(pt.default_startup_program())\n"
        "for _ in range(2):\n"
        "    exe.run(feed={'x': np.ones((2, 3), np.float32)},\n"
        "            fetch_list=[y])\n"
        "assert exe.place == pt.CPUPlace()\n")
    pt.framework.reset_default_programs()
    trace = tiny / "trace.json"
    assert cli.main(["stats", f"--run={script}", "--use_gpu=0", "--json",
                     f"--trace={trace}"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert "executor_compile_cache_hit_total" in snap
    assert json.loads(trace.read_text())
    art = tiny / "art.json"
    art.write_text(json.dumps({"metrics": snap}))
    assert cli.main(["stats", f"--file={art}"]) == 0
    got = capsys.readouterr().out
    assert jcli.cmd_stats([f"--file={art}"]) == 0
    assert got == capsys.readouterr().out
    assert cli.main(["stats", "--url=http://x", "--trace=t"]) == 2


def test_serve_parses_the_launchers_flags(tiny):
    """paddle serve and python -m paddle_tpu_torch.serving parse one set
    of flags: --use_gpu=0 (and --cpu) serve on the CPU, --tenant_config
    takes one entry a line with # comments, or JSON; a usage error exits
    2; no card and no --use_gpu=0 raises."""
    import torch

    from paddle_tpu_torch.serving.__main__ import (make_server,
                                                   parse_serve_args,
                                                   serve_parser)

    fluid.framework.reset_default_programs()
    x = fluid.layers.data(name="x", shape=[4])
    pred = fluid.layers.fc(input=x, size=2)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    export = str(tiny / "export")
    fluid.io.save_inference_model(export, ["x"], [pred], exe)
    lines = tiny / "tenants.txt"
    lines.write_text("# tenants\nA:5:2\nB:::3\n")
    ap = serve_parser("paddle serve", port=0)
    args = parse_serve_args(ap, [f"--model_dir={export}", "--use_gpu=0",
                                 f"--tenant_config={lines}", "--warmup",
                                 "--max_batch=4"])
    srv = make_server(args)
    try:
        assert srv.place == pt.CPUPlace()
        quotas = srv._tenants._tenants
        assert sorted(quotas) == ["A", "B"]
        assert (quotas["A"].rate, quotas["A"].burst) == (5.0, 2.0)
        assert quotas["B"].weight == 3.0
    finally:
        srv.stop()
    assert parse_serve_args(ap, [f"--model_dir={export}", "--cpu"]).cpu
    assert serve_parser("x").parse_args([]).port == 8000
    assert cli.main(["serve"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            make_server(parse_serve_args(ap, [f"--model_dir={export}"]))


def test_usage_version_and_later_commands(capsys):
    """No command: the usage and exit 2; an unknown one: exit 2;
    version names the cards or "no CUDA device"; compile and tune answer
    (no "not yet"), their usage errors exiting 2 as the reference's do;
    pserver, master, coord and elastic exit 1 naming their ROADMAP
    step."""
    import torch

    assert cli.main([]) == 2
    assert cli.main(["--help"]) == 0
    assert "merge_model" in capsys.readouterr().out
    assert cli.main(["bogus"]) == 2
    assert "unknown command" in capsys.readouterr().err
    assert cli.main(["version"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"paddle_tpu_torch {pt.__version__}")
    assert torch.__version__ in out
    if not torch.cuda.is_available():
        assert "no CUDA device" in out
    assert set(cli.COMMANDS) == set(jcli.COMMANDS)
    for name, step in (("pserver", "step 6"), ("master", "step 6"),
                       ("coord", "step 6"), ("elastic", "step 6")):
        assert cli.main([name, "--port=0"]) == 1
        err = capsys.readouterr().err
        assert f"ROADMAP Queue 1 item 3 {step}" in err and name in err
    for argv in (["compile"], ["compile", "--out=x"],
                 ["tune", "--kernel=bogus"]):
        assert cli.main(argv) == jcli.COMMANDS[argv[0]](argv[1:]) == 2, argv
        err = capsys.readouterr().err
        assert "not yet" not in err and ("usage" in err
                                         or "unknown kernel" in err)
