"""The v1 trainer (``paddle_tpu/trainer/trainer.py``): ``Trainer`` builds
a parsed config's topology on the port's v2 stack, iterates its
PyDataProvider2 sources pass by pass (``train``, ``test``), checks its
gradients by central differences (``check_gradient``), saves a
``save_dir/pass-%05d/params.tar`` a pass and exports the prediction
slice; ``main`` is the ``paddle_trainer`` command line
(``python -m paddle_tpu_torch.trainer``).  It trains on ``CUDAPlace(0)``
unless the caller passes another place.  ``log_period`` defaults to
``FLAGS.log_period``; with ``FLAGS.show_layer_stat`` every log line is
followed by the telemetry registry's table and ``stat.GLOBAL_STATS``."""

from __future__ import annotations

import importlib
import os
import sys
import time
from typing import Optional

import numpy as np

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import stat
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import Place, resolve_place
from paddle_tpu_torch.trainer.config_parser import TrainerConfig, parse_config


def _resolve_log_period(log_period):
    """An explicit argument wins; otherwise the flag tier's log_period
    (reference: utils/Flags.cpp FLAGS_log_period, default 100)."""
    if log_period is not None:
        return max(int(log_period), 1)
    return max(int(FLAGS.get("log_period", 100) or 100), 1)


def _dump_layer_stat(pass_id, batch_id, out=None):
    """--show_layer_stat: the runtime telemetry registry (plan-cache,
    step and feed metrics per program) and any host StatSet timers,
    every log_period batches (reference: Stat.h printAllStatus under
    WITH_TIMER and FLAGS_show_layer_stat)."""
    out = out or sys.stderr
    print(f"--- runtime stats (pass {pass_id}, batch {batch_id}) ---",
          file=out)
    table = obs.format_snapshot(obs.snapshot())
    if table:
        print(table, file=out)
    if stat.GLOBAL_STATS.items():
        stat.GLOBAL_STATS.print_status(out=out)


class Trainer:
    """A parsed v1 config ready to train on ``place``: ``t.parameters``
    (its scope holds the weights and the optimizer's state),
    ``t._sgd.topology`` (``main_program``, ``cost_var``, ``feed_types``)."""

    def __init__(self, conf: TrainerConfig, place: Optional[Place] = None):
        from paddle_tpu_torch.v2 import parameters as v2_params
        from paddle_tpu_torch.v2.topology import Topology
        from paddle_tpu_torch.v2.trainer import SGD

        if conf.cost is None:
            raise ValueError("config declared no outputs(); nothing to train")
        place = resolve_place(place)   # the card's absence raises here
        self.conf = conf
        settings = dict(conf.opt_config or {})
        lr = settings.get("learning_rate", 1e-3)
        method = settings.get("learning_method")
        opt_kwargs = {}
        thr = settings.get("gradient_clipping_threshold")
        if thr:
            from paddle_tpu_torch.clip import GradientClipByGlobalNorm

            opt_kwargs["grad_clip"] = GradientClipByGlobalNorm(thr)
        if settings.get("regularization") is not None:
            opt_kwargs["regularization"] = settings["regularization"]
        optimizer = (method.to_optimizer(lr, **opt_kwargs)
                     if method is not None else None)
        if optimizer is None:
            from paddle_tpu_torch import optimizer as opt

            optimizer = opt.SGD(learning_rate=lr, **opt_kwargs)
        self.batch_size = settings.get("batch_size", 32)
        topo = Topology(conf.cost, extra_layers=conf.evaluators)
        params = v2_params.Parameters(topo, place)
        self._sgd = SGD(cost=conf.cost, parameters=params,
                        update_equation=optimizer)
        self.parameters = params

    # -- data ---------------------------------------------------------------

    def _reader_from_sources(self, train: bool = True):
        """A reader over the config's train (or test) source: the
        provider called for each file of the list (a file of names, or
        the name itself), its samples in batches of ``batch_size``, the
        last one short."""
        src = self.conf.data_sources
        if src is None:
            raise ValueError("config has no define_py_data_sources2")
        mod = src["module"]
        if isinstance(mod, str):
            mod = importlib.import_module(mod)
        provider = getattr(mod, src["obj"])
        files = src["train_list"] if train else src["test_list"]
        if isinstance(files, str):
            if os.path.exists(files):
                with open(files) as f:
                    files = [l.strip() for l in f if l.strip()]
            else:
                files = [files]
        files = files or [None]
        batch_size = self.batch_size
        feed_order = [name for name, _ in self._sgd.topology.feed_types]

        def reader():
            batch = []
            for fname in files:
                for sample in provider(fname, **src.get("args", {})):
                    if isinstance(sample, dict):  # the dict-yield protocol
                        sample = tuple(sample[n] for n in feed_order)
                    batch.append(sample)
                    if len(batch) == batch_size:
                        yield batch
                        batch = []
            if batch:
                yield batch

        return reader

    # -- training -----------------------------------------------------------

    def train(self, num_passes: int = 1, save_dir: Optional[str] = None,
              log_period: Optional[int] = None, event_handler=None):
        """Train ``num_passes`` passes over the train source; every
        batch's cost, in order.  A line a ``log_period`` batches
        (default ``FLAGS.log_period``, 100), followed by the runtime
        stats under ``FLAGS.show_layer_stat``; with ``save_dir``,
        ``pass-%05d/params.tar`` at the end of each pass."""
        from paddle_tpu_torch.v2 import event as v2_event

        log_period = _resolve_log_period(log_period)
        costs = []

        def handler(e):
            if isinstance(e, v2_event.EndIteration):
                costs.append(e.cost)
                if e.batch_id % log_period == 0:
                    evals = "".join(f" {n}={v:.6g}"
                                    for n, v in sorted(e.metrics.items()))
                    print(f"Pass {e.pass_id}, Batch {e.batch_id}, "
                          f"Cost {e.cost:.6f}"
                          + (f", Eval:{evals}" if evals else ""),
                          flush=True)
                    if FLAGS.get("show_layer_stat"):
                        _dump_layer_stat(e.pass_id, e.batch_id)
            if isinstance(e, v2_event.EndPass) and save_dir:
                pass_dir = os.path.join(save_dir, f"pass-{e.pass_id:05d}")
                os.makedirs(pass_dir, exist_ok=True)
                with open(os.path.join(pass_dir, "params.tar"), "wb") as f:
                    self.parameters.to_tar(f)
            if event_handler is not None:
                event_handler(e)

        self._sgd.train(self._reader_from_sources(train=True),
                        num_passes=num_passes, event_handler=handler)
        return costs

    def test(self):
        return self._sgd.test(self._reader_from_sources(train=False))

    def check_gradient(self, epsilon: float = 1e-3, max_elems: int = 8,
                       rtol: float = 1e-2, atol: float = 1e-2):
        """Central-difference check of the config's parameters on one
        batch of the train source: up to ``max_elems`` elements a
        parameter, each analytic dCost/dW against
        (cost(w + eps) - cost(w - eps)) / 2 eps.  Returns {name: largest
        |analytic - numeric|}; raises AssertionError on a mismatch (the
        parameter restored first)."""
        import paddle_tpu_torch.framework as framework
        from paddle_tpu_torch.backward import append_backward
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.v2.trainer import V2DataFeeder

        topo = self._sgd.topology
        batch = next(iter(self._reader_from_sources(train=True)()))
        feed = V2DataFeeder(topo.feed_types).feed(batch)
        # gradients before any update: a test clone of the forward with
        # the backward appended
        prog = topo.main_program.clone(for_test=True)
        with framework.program_guard(prog):
            loss = prog.global_block().var(topo.cost_var.name)
            pairs = append_backward(loss)
        exe = Executor(self.parameters.place)
        scope = self.parameters.scope
        cost_name = topo.cost_var.name
        vals = exe.run(prog, feed=feed, scope=scope,
                       fetch_list=[cost_name] + [g.name for _, g in pairs])
        analytic = {p.name: np.asarray(g)
                    for (p, _), g in zip(pairs, vals[1:])}

        def cost_with(name, arr):
            self.parameters.set(name, arr)
            (c,) = exe.run(prog, feed=feed, fetch_list=[cost_name],
                           scope=scope)
            return float(np.asarray(c).reshape(-1)[0])

        report = {}
        rng = np.random.RandomState(0)
        for name in self.parameters.keys():
            if name not in analytic:
                continue
            base = np.array(self.parameters.get(name))
            flat = base.reshape(-1)
            idx = rng.choice(flat.size, size=min(max_elems, flat.size),
                             replace=False)
            worst = 0.0
            for i in idx:
                pert = flat.copy()
                pert[i] += epsilon
                up = cost_with(name, pert.reshape(base.shape))
                pert[i] -= 2 * epsilon
                down = cost_with(name, pert.reshape(base.shape))
                num = (up - down) / (2 * epsilon)
                ana = float(analytic[name].reshape(-1)[i])
                diff = abs(num - ana)
                worst = max(worst, diff)
                if diff > atol + rtol * abs(num):
                    self.parameters.set(name, base)
                    raise AssertionError(
                        f"checkgrad: {name}[{i}] analytic {ana:.6f} vs "
                        f"numeric {num:.6f} (eps={epsilon})")
            self.parameters.set(name, base)
            report[name] = worst
        return report

    # -- models ---------------------------------------------------------------

    def load_parameters(self, model_dir: str):
        """Load a params.tar: a pass dir, a save_dir (its latest pass) or
        the tar's own path."""
        path = model_dir
        if os.path.isdir(path):
            passes = sorted(d for d in os.listdir(path)
                            if d.startswith("pass-"))
            if passes:
                path = os.path.join(path, passes[-1])
            path = os.path.join(path, "params.tar")
        with open(path, "rb") as f:
            self.parameters.load_tar(f)

    def export_inference_model(self, out_dir: str):
        """The prediction slice (the cost's first parent that is not a
        data layer) and its parameters as a ``save_inference_model``
        directory."""
        from paddle_tpu_torch import io as fluid_io
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.v2.topology import Topology

        cost = self.conf.cost
        data_names = set(self.conf.data_layers)
        pred = next((p for p in cost.parents if p.name not in data_names),
                    cost)
        topo = Topology(output_layers=[pred], is_test=True)
        exe = Executor(self.parameters.place)
        fluid_io.save_inference_model(
            out_dir, topo.feed_names(), topo.output_vars, exe,
            main_program=topo.main_program, scope=self.parameters.scope)
        return out_dir


def train_from_config(config_path: str, num_passes: int = 1,
                      save_dir: Optional[str] = None,
                      config_args: str = "", place: Optional[Place] = None,
                      init_model_path: Optional[str] = None, **kwargs):
    """Parse ``config_path`` and train it on ``place`` (the card unless
    given), from the parameters at ``init_model_path`` where given (see
    ``Trainer.load_parameters``); (trainer, every batch's cost)."""
    conf = parse_config(config_path, config_args)
    t = Trainer(conf, place)
    if init_model_path:
        t.load_parameters(init_model_path)
    costs = t.train(num_passes=num_passes, save_dir=save_dir, **kwargs)
    return t, costs


def main(argv=None):
    """``python -m paddle_tpu_torch.trainer --config=conf.py``: the
    paddle_trainer command line (``--job=train|test|checkgrad``,
    ``--num_passes``, ``--save_dir``, ``--init_model_path``,
    ``--config_args``, ``--log_period``, ``--show_layer_stat``;
    ``--use_gpu=0`` trains on the CPU)."""
    import argparse

    from paddle_tpu_torch.framework import CPUPlace, CUDAPlace

    p = argparse.ArgumentParser(prog="paddle_trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--job", default="train",
                   choices=["train", "test", "checkgrad"],
                   help="train | test (the cost over the test source) | "
                        "checkgrad (central differences)")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--init_model_path", default=None,
                   help="a pass dir, a save_dir or a params.tar to load "
                        "before training, testing or checking")
    p.add_argument("--config_args", default="")
    p.add_argument("--log_period", type=int, default=None,
                   help="batches between log lines (default: the "
                        "log_period flag, 100)")
    p.add_argument("--show_layer_stat", action="store_true",
                   help="print the runtime stats table after every log "
                        "line")
    p.add_argument("--use_gpu", type=int, default=1,
                   help="1: train on CUDAPlace(0); 0: on the CPU")
    p.add_argument("--trainer_count", type=int, default=1)
    a = p.parse_args(argv)
    if a.trainer_count > 1:
        raise NotImplementedError(
            "paddle_tpu_torch: --trainer_count > 1 comes with the parallel "
            "slice")
    if a.show_layer_stat:
        FLAGS.set("show_layer_stat", True)
    place = CUDAPlace(0) if a.use_gpu else CPUPlace()
    t0 = time.time()
    if a.job in ("test", "checkgrad"):
        t = Trainer(parse_config(a.config, a.config_args), place)
        if a.init_model_path:
            t.load_parameters(a.init_model_path)
        if a.job == "test":
            result = t.test()
            evals = "".join(f" {n}={v:.6g}"
                            for n, v in sorted(result.metrics.items()))
            cost = result.cost if result.cost is not None else float("nan")
            print(f"Test done in {time.time() - t0:.1f}s, cost {cost:.6f}"
                  + (f", Eval:{evals}" if evals else ""), flush=True)
            return 0
        report = t.check_gradient()
        for name, diff in sorted(report.items()):
            print(f"checkgrad {name}: max |analytic - numeric| = "
                  f"{diff:.6g}", flush=True)
        print(f"Gradient check PASSED ({len(report)} parameters, "
              f"{time.time() - t0:.1f}s)", flush=True)
        return 0
    _, costs = train_from_config(a.config, num_passes=a.num_passes,
                                 save_dir=a.save_dir,
                                 config_args=a.config_args, place=place,
                                 init_model_path=a.init_model_path,
                                 log_period=a.log_period)
    final = float(np.mean(costs[-10:])) if costs else float("nan")
    print(f"Training done: {len(costs)} batches in {time.time() - t0:.1f}s, "
          f"final cost {final:.6f}", flush=True)
    return 0
