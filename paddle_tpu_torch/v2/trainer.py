"""The v2 trainer (``paddle_tpu/v2/trainer.py``): ``V2DataFeeder``, which
turns reader rows into the padded feed layout; ``SGD``, which appends
the optimizer to the topology's program and drives it batch by batch
with events (``train``, ``test``, the prefetching pass); and
``CheckpointHandler``, which commits params and optimizer state every
few iterations.  Remote (parameter-server) training and
``trainer_count > 1`` wait for the distributed and parallel slices."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.v2 import event as v2_event
from paddle_tpu_torch.v2.layer import LayerOutput
from paddle_tpu_torch.v2.parameters import Parameters


def _round_up(n, m):
    return ((n + m - 1) // m) * m


class V2DataFeeder:
    """Reader rows -> the padded dense feed layout: a sequence column is
    (B, T[, dim]) with T rounded up to ``time_bucket`` beside its
    ``<name>@len`` lengths; a nested one (B, S, T[, dim]) beside
    ``@len`` (subsequences a row) and ``@sublen`` (steps a subsequence);
    a sparse one a dense (B, dim) multi-hot or weighted row."""

    def __init__(self, feed_types: List,
                 feeding: Optional[Dict[str, int]] = None,
                 time_bucket: int = 16):
        self.feed_types = feed_types  # [(name, InputType)]
        self.feeding = feeding
        self.time_bucket = time_bucket

    def feed(self, minibatch: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        out = {}
        for col, (name, t) in enumerate(self.feed_types):
            idx = self.feeding[name] if self.feeding else col
            column = [row[idx] for row in minibatch]
            if getattr(t, "seq_type", 0) == 2:
                out.update(self._nested(name, t, column))
            elif t.is_seq:
                lens = np.asarray([len(c) for c in column], np.int32)
                T = _round_up(max(int(lens.max()), 1), self.time_bucket)
                if t.dtype == "int64":
                    arr = np.zeros((len(column), T), np.int64)
                else:
                    arr = np.zeros((len(column), T, t.dim), np.float32)
                for i, c in enumerate(column):
                    arr[i, :len(c)] = np.asarray(c, arr.dtype)
                out[name] = arr
                out[name + "@len"] = lens
            elif getattr(t, "sparse", False):
                dense = np.zeros((len(column), t.dim), np.float32)
                for i, c in enumerate(column):
                    if len(c) and isinstance(c[0], (tuple, list)):
                        for j, v in c:
                            dense[i, j] = v
                    else:
                        dense[i, np.asarray(c, np.int64)] = 1.0
                out[name] = dense
            elif t.dtype == "int64":
                out[name] = np.asarray(column, np.int64).reshape(
                    len(column), -1)
            else:
                arr = np.asarray(column, np.float32)
                out[name] = arr.reshape(-1, 1) if arr.ndim == 1 else arr
        return out

    def _nested(self, name, t, column):
        B = len(column)
        outer = np.asarray([len(r) for r in column], np.int32)
        S = max(int(outer.max()), 1)
        inner = np.zeros((B, S), np.int32)
        for i, r in enumerate(column):
            for j, sub in enumerate(r):
                inner[i, j] = len(sub)
        T = _round_up(max(int(inner.max()), 1), self.time_bucket)
        if t.dtype == "int64":
            arr = np.zeros((B, S, T), np.int64)
        else:
            arr = np.zeros((B, S, T, t.dim), np.float32)
        for i, r in enumerate(column):
            for j, sub in enumerate(r):
                arr[i, j, :len(sub)] = np.asarray(sub, arr.dtype)
        return {name: arr, name + "@len": outer, name + "@sublen": inner}


class CheckpointHandler:
    """An event handler that makes training crash-resumable: every
    ``period`` iterations, and at every EndPass, the trainer's
    persistables (params and optimizer accumulators) go to
    ``dirname/step_N`` through ``io.save_checkpoint``, committed by a
    ``step_N.complete`` marker, with ``max_to_keep`` retention.  Step
    numbers continue from the newest complete checkpoint on disk."""

    def __init__(self, trainer: "SGD", dirname: str, period: int = 100,
                 max_to_keep: int = 3):
        from paddle_tpu_torch import io as io_mod

        self._trainer = trainer
        self._io = io_mod
        self.dirname = dirname
        self.period = max(int(period), 1)
        self.max_to_keep = max_to_keep
        self.step = io_mod.latest_checkpoint_step(dirname) or 0

    def save(self) -> str:
        return self._io.save_checkpoint(
            self.dirname,
            main_program=self._trainer.topology.main_program,
            step=self.step, scope=self._trainer.parameters.scope,
            max_to_keep=self.max_to_keep)

    def __call__(self, event):
        if isinstance(event, v2_event.EndIteration):
            self.step += 1
            if self.step % self.period == 0:
                self.save()
        elif isinstance(event, v2_event.EndPass):
            self.save()


def _first(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.detach().reshape(-1)[0])
    return float(np.asarray(value).reshape(-1)[0])


class SGD:
    """paddle.v2.trainer.SGD: ``update_equation.minimize`` on the
    topology's cost, then the startup program (grown by the learning
    rate and the accumulators) run into ``parameters``' scope on its
    place."""

    def __init__(self, cost: LayerOutput, parameters: Parameters,
                 update_equation, extra_layers=None, is_local: bool = True,
                 pserver_addrs=None, **kwargs):
        if not is_local:
            raise NotImplementedError(
                "paddle_tpu_torch: remote (parameter-server) training comes "
                "with the distributed slice")
        from paddle_tpu_torch import v2

        if v2._trainer_count > 1:
            raise NotImplementedError(
                "paddle_tpu_torch: trainer_count > 1 comes with the parallel "
                "slice")
        self.topology = parameters.topology
        self.parameters = parameters
        self._extra = list(extra_layers or [])
        with framework.program_guard(self.topology.main_program,
                                     self.topology.startup_program):
            update_equation.minimize(
                self.topology.cost_var,
                startup_program=self.topology.startup_program)
        exe = Executor(parameters.place)
        exe.run(self.topology.startup_program, scope=parameters.scope)
        self._exe = exe
        self._test_program = None

    def restore_checkpoint(self, dirname: str,
                           step: Optional[int] = None) -> Optional[int]:
        """Load the newest complete checkpoint under ``dirname`` (or
        ``step``) into the parameters' scope, params and optimizer
        accumulators both; the restored step, or None when there is no
        complete checkpoint."""
        from paddle_tpu_torch import io as io_mod

        if step is None:
            step = io_mod.latest_checkpoint_step(dirname)
            if step is None:
                return None
        io_mod.load_checkpoint(dirname, self._exe,
                               main_program=self.topology.main_program,
                               step=step, scope=self.parameters.scope)
        return step

    def _metric_fetch(self):
        """(fetch_list, metric_names): the cost, then every evaluator
        output that carries a display name, repeated names suffixed
        _1, _2, ...  Shared by train() and test()."""
        fetch = [self.topology.cost_var]
        names = []
        seen = {}
        for lo, var in zip(getattr(self.topology, "output_layers", []),
                           self.topology.output_vars):
            ename = getattr(lo, "_eval_name", None)
            if ename is None:
                continue
            if ename in seen:
                seen[ename] += 1
                ename = f"{ename}_{seen[ename]}"
            else:
                seen[ename] = 0
            fetch.append(var)
            names.append(ename)
        return fetch, names

    @staticmethod
    def _scalar_metrics(names, vals):
        out = {}
        for nm, v in zip(names, vals):
            arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
            if arr.size == 1:
                out[nm] = float(arr.reshape(()))
        return out

    def _run(self, program, feed, fetch, return_numpy=True):
        return self._exe.run(program, feed=feed, fetch_list=fetch,
                             scope=self.parameters.scope,
                             return_numpy=return_numpy)

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None,
              prefetch: bool = False,
              checkpoint_dir: Optional[str] = None,
              checkpoint_period: int = 100):
        """Run ``num_passes`` passes over ``reader()``'s batches, with
        BeginPass / BeginIteration / EndIteration / EndPass events.

        ``prefetch=True`` stages batch N+1 on the device while step N runs
        and reads step N's cost one step later, so EndIteration events
        come one step late, with exact costs.  ``checkpoint_dir`` adds a
        :class:`CheckpointHandler` (period ``checkpoint_period``); call
        ``restore_checkpoint(checkpoint_dir)`` before ``train`` to resume."""
        event_handler = event_handler or (lambda e: None)
        if checkpoint_dir is not None:
            ckpt = CheckpointHandler(self, checkpoint_dir,
                                     period=checkpoint_period)
            user_handler = event_handler

            def event_handler(e, _u=user_handler, _c=ckpt):
                _u(e)
                _c(e)
        feeder = V2DataFeeder(self.topology.feed_types, feeding)
        fetch, metric_names = self._metric_fetch()
        program = self.topology.main_program
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            if prefetch:
                self._train_pass_prefetch(reader, feeder, fetch,
                                          metric_names, pass_id,
                                          event_handler)
            else:
                for batch_id, data in enumerate(reader()):
                    event_handler(v2_event.BeginIteration(pass_id, batch_id))
                    cost, *extra = self._run(program, feeder.feed(data),
                                             fetch)
                    event_handler(v2_event.EndIteration(
                        pass_id, batch_id, _first(cost),
                        metrics=self._scalar_metrics(metric_names, extra)))
            event_handler(v2_event.EndPass(pass_id))

    def _stage(self, feed: Dict[str, np.ndarray]):
        """The feed on the run's device: on a card, each array copied
        into pinned host memory and sent with a non-blocking copy, queued
        behind the step in flight."""
        device = self._exe.device
        if device.type != "cuda":
            return feed
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in feed.items()}

    def _train_pass_prefetch(self, reader, feeder, fetch, metric_names,
                             pass_id, event_handler):
        program = self.topology.main_program

        def emit(bid, cost, extra):
            event_handler(v2_event.EndIteration(
                pass_id, bid, _first(cost),
                metrics=self._scalar_metrics(metric_names, extra)))

        pending = None  # (batch_id, cost tensor, evaluator tensors)
        try:
            it = enumerate(reader())
            nxt = next(it, None)
            staged = self._stage(feeder.feed(nxt[1])) if nxt else None
            while nxt is not None:
                batch_id = nxt[0]
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                cost, *extra = self._run(program, staged, fetch,
                                         return_numpy=False)
                # stage batch N+1 while the device runs step N
                nxt = next(it, None)
                if nxt is not None:
                    staged = self._stage(feeder.feed(nxt[1]))
                if pending is not None:
                    args, pending = pending, None
                    # consumed before it is emitted: a raising handler
                    # must not see the event again from ``finally``
                    emit(*args)
                pending = (batch_id, cost, extra)
        finally:
            # a failure in step N must not drop step N-1's EndIteration
            if pending is not None:
                emit(*pending)

    def test(self, reader: Callable,
             feeding: Optional[Dict[str, int]] = None):
        """The cost and the scalar evaluator outputs over ``reader()``'s
        batches on the program's test clone; the metrics averaged with
        each batch weighted by its samples."""
        if self._test_program is None:
            self._test_program = self.topology.main_program.clone(
                for_test=True)
        feeder = V2DataFeeder(self.topology.feed_types, feeding)
        fetch, metric_names = self._metric_fetch()
        costs = []
        sums: Dict[str, float] = {}
        n_samples = 0
        for data in reader():
            cost, *extra = self._run(self._test_program, feeder.feed(data),
                                     fetch)
            costs.append(_first(cost))
            bsz = len(data)
            n_samples += bsz
            for nm, v in self._scalar_metrics(metric_names, extra).items():
                sums[nm] = sums.get(nm, 0.0) + v * bsz
        metrics = ({nm: s / n_samples for nm, s in sums.items()}
                   if n_samples else {})
        return v2_event.TestResult(
            cost=float(np.mean(costs)) if costs else None, metrics=metrics)
