"""Export entry points: the serving warm-up paths run under capture
(``paddle_tpu/aot/export.py``).

An ``ArtifactWriter`` is made the active exporter, then the code a serving
boot runs (the replica's bucket ladder; or one short generation through
the decode engine) runs on zero-filled feeds.  Every plan an Executor
builds in that window is recorded, so the artifact holds exactly the
plans a ``--warmup`` boot builds, already optimized (``ModelBundle``
rewrites the program before any replica runs it, and the optimized
program's fingerprint keys the entry), and the writer's ``finish`` copies
the kernel libraries the process loaded.
"""

from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch.aot.artifact import ArtifactWriter


def export_model(model_dir: str, out_dir: str, *, max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 optimize: bool = True, place=None,
                 writer: Optional[ArtifactWriter] = None,
                 finish: bool = True) -> ArtifactWriter:
    """Export the bucket ladder of a save_inference_model directory, as
    ``ReplicaPool.warmup()`` runs it: one replica (its own Scope and
    Executor on ``place``, CUDA card 0 when None) runs a zero-filled batch
    a bucket, each plan recorded into ``writer``.  Returns the writer;
    with ``finish`` (the default) the manifest is written too."""
    import numpy as np

    from paddle_tpu_torch import aot as _aot
    from paddle_tpu_torch.serving.batching import bucket_ladder
    from paddle_tpu_torch.serving.replica import ModelBundle, Replica

    bundle = ModelBundle(model_dir, optimize=optimize)
    spec = bundle.batch_spec()
    if not spec.batchable:
        raise RuntimeError(
            f"cannot export {model_dir}: the model is not batch-major "
            f"({spec.reason}), so there is no bucket ladder to plan ahead")
    rep = Replica(bundle, 0, place)
    writer = writer or ArtifactWriter(out_dir, rep.exe.place)
    buckets = tuple(buckets or bucket_ladder(max_batch))
    with _aot.capture(writer):
        for b in buckets:
            rep.run({name: np.zeros((b,) + spec.row_shapes[name],
                                    dtype=spec.dtypes[name])
                     for name in spec.feed_names})
    if finish:
        writer.finish(extra={"model_dir": model_dir,
                             "buckets": list(buckets)})
    return writer


def export_generator(generator, out_dir: str, *,
                     prompt_ids: Optional[Sequence[int]] = None,
                     max_new_tokens: int = 2,
                     writer: Optional[ArtifactWriter] = None,
                     finish: bool = True) -> ArtifactWriter:
    """Run one short generation of a GenerationEngine under capture.  The
    port's decode engine runs its model directly, through no Executor, so
    it records no entry (as the JAX package's decoder LM exports none);
    the kernel libraries it loads still go into the artifact."""
    from paddle_tpu_torch import aot as _aot

    writer = writer or ArtifactWriter(out_dir, generator.model.place)
    ids = list(prompt_ids) if prompt_ids else [
        int(getattr(generator.model, "bos_id", 1) or 1)]
    with _aot.capture(writer):
        req = generator.submit(ids, max_new_tokens=max_new_tokens)
        req.result(timeout=600)
    if finish:
        writer.finish(extra={"generator": True})
    return writer
