"""Executor replicas for the serving engine
(``paddle_tpu/serving/replica.py``, without supervision).

Each ``Replica`` owns its own ``Scope`` (its own copy of the parameters,
loaded from the export onto its device) and its own ``Executor``, so
nothing is locked because nothing mutable is shared.  The one shared
object is the parsed ``Program``, read-only after shape propagation.
Workers pull dispatch groups from the ``RequestQueue``: while one
replica is inside a forward, admission and batch formation go on.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import io
from paddle_tpu_torch.executor import Executor, Scope
from paddle_tpu_torch.serving.batching import (BatchSpec, PendingRequest,
                                               RequestQueue, bucket_ladder,
                                               coalesce, scatter)


class ModelBundle:
    """One parse of a save_inference_model export, shared by replicas."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self.program, feed_names, fetch_names, self.param_names = \
            io.read_inference_export(model_dir)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)

    def batch_spec(self) -> BatchSpec:
        return BatchSpec.from_program(self.program, self.feed_names,
                                      self.fetch_names)

    def load_params_into(self, scope: Scope, device) -> None:
        scope.load_numpy(
            {name: io.load_exported_param(self.model_dir, name)
             for name in self.param_names}, device)


class Replica:
    """One worker clone: private Scope + private Executor on ``place``
    (``CUDAPlace(0)`` when None)."""

    def __init__(self, bundle: ModelBundle, index: int, place=None):
        self.index = index
        self.bundle = bundle
        self.exe = Executor(place)
        self.scope = Scope()
        bundle.load_params_into(self.scope, self.exe.device)

    def run(self, feeds) -> list:
        return list(self.exe.run(self.bundle.program, feed=feeds,
                                 fetch_list=list(self.bundle.fetch_names),
                                 scope=self.scope))


class ReplicaPool:
    """N replicas, each a worker thread pulling batches from one queue."""

    def __init__(self, bundle: ModelBundle, queue: RequestQueue,
                 spec: BatchSpec, replicas: int = 1, place=None):
        self.bundle = bundle
        self.queue = queue
        self.spec = spec
        self.replicas: List[Replica] = [
            Replica(bundle, i, place) for i in range(max(1, int(replicas)))]
        self._threads = [
            threading.Thread(target=self._worker, args=(rep,), daemon=True,
                             name=f"serving-replica-{rep.index}")
            for rep in self.replicas]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self.queue.close()
        for t in self._threads:
            t.join(timeout=30.0)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Run the bucket ladder once on every replica with zero batches,
        so the first live request finds the kernels built and the
        executor's plans cached.  Returns the number of (replica,
        bucket) runs."""
        if not self.spec.batchable:
            return 0
        buckets = tuple(buckets or bucket_ladder(self.queue.max_batch))

        def _one(rep):
            for b in buckets:
                rep.run({name: np.zeros((b,) + self.spec.row_shapes[name],
                                        dtype=self.spec.dtypes[name])
                         for name in self.spec.feed_names})

        # map() re-raises a replica's warmup error here
        with concurrent.futures.ThreadPoolExecutor(len(self.replicas)) as ex:
            list(ex.map(_one, self.replicas))
        return len(buckets) * len(self.replicas)

    def _worker(self, rep: Replica) -> None:
        while True:
            batch = self.queue.take()
            if batch is None:
                return
            self._execute(rep, batch)

    def _execute(self, rep: Replica, batch: List[PendingRequest]) -> None:
        try:
            if len(batch) == 1 and not batch[0].batchable:
                batch[0].complete(rep.run(batch[0].feeds))
                return
            feeds, rows, bucket = coalesce(batch, self.spec)
            for req in batch:
                req.bucket = bucket
            scatter(batch, rep.run(feeds), bucket)
        except Exception as exc:  # noqa: BLE001 - the worker keeps serving
            # the waiters get the error (400 for a request's own fault,
            # 500 otherwise); the replica stays up for the next batch
            for req in batch:
                req.fail(exc)
