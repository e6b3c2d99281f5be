"""``paddle compile``: export AOT serving artifacts
(``paddle_tpu/aot/compile_cli.py``).

Usage:
  paddle compile --model_dir=DIR --out=DIR [--max_batch=N]
                 [--buckets=1,2,4] [--no-optimize] [--cpu | --use_gpu=0]
                 [--gen_config=SCRIPT [--gen_*=... --prefix_cache ...]]
  paddle compile --smoke [--cpu]

Runs the serving warm-up paths under export capture
(``paddle_tpu_torch/aot``): the run plan of every bucket of the ladder
(and, with --gen_config, one short generation, which records the kernel
libraries its decode steps load) is recorded with the kernel libraries
the process loaded, under a versioned manifest.  ``paddle serve
--artifacts=DIR`` then boots replicas from the store.  The export runs on
CUDA card 0, or on the CPU with ``--cpu`` (a CPU export holds no
library, and serves a CPU server).

--smoke is the self-contained check: a throwaway MLP export, compiled,
served once plan-booted and once from the artifacts; the artifact boot
must answer from loaded plans only, with /predict replies equal byte for
byte.
"""

from __future__ import annotations

import json
import os
import sys

from paddle_tpu_torch.aot.artifact import ArtifactWriter
from paddle_tpu_torch.aot.export import export_generator, export_model

USAGE = ("usage: paddle compile --model_dir=DIR --out=DIR [--max_batch=N] "
         "[--buckets=1,2,...] [--no-optimize] [--cpu] "
         "[--gen_config=SCRIPT ...] | paddle compile --smoke [--cpu]")


def _parse(argv):
    args, rest = {}, []
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            args[k] = v
        else:
            rest.append(a)
    return args, rest


def _place(args, rest):
    from paddle_tpu_torch.framework import CPUPlace, CUDAPlace

    cpu = "--cpu" in rest or args.get("use_gpu", "1") in ("0", "false")
    return CPUPlace() if cpu else CUDAPlace(0)


def _generator(args, rest):
    """The GenerationEngine ``--gen_config`` and the ``--gen_*`` flags
    describe, through ``paddle serve``'s parser."""
    from paddle_tpu_torch.serving.__main__ import load_generator, serve_parser

    flags = [f"--{k}={v}" for k, v in args.items()
             if k == "gen_config" or k.startswith(("gen_", "spec_"))
             or k in ("beam_max", "prefix_cache_pages", "use_gpu")]
    flags += [a for a in rest if a in ("--prefix_cache", "--cpu")]
    return load_generator(serve_parser("paddle compile").parse_args(flags))


def main(argv) -> int:
    args, rest = _parse(argv)
    if "--smoke" in rest:
        return smoke(_place(args, rest))
    model_dir = args.get("model_dir")
    out = args.get("out")
    if not out or (not model_dir and not args.get("gen_config")):
        print(USAGE, file=sys.stderr)
        return 2
    try:
        buckets = ([int(b) for b in args["buckets"].split(",") if b]
                   if args.get("buckets") else None)
        max_batch = int(args.get("max_batch", 8))
    except ValueError as e:
        print(f"paddle compile: {e}\n{USAGE}", file=sys.stderr)
        return 2
    place = _place(args, rest)
    writer = ArtifactWriter(out, place)
    if model_dir:
        export_model(model_dir, out, max_batch=max_batch, buckets=buckets,
                     optimize="--no-optimize" not in rest, place=place,
                     writer=writer, finish=False)
    if args.get("gen_config"):
        gen = _generator(args, rest)
        try:
            export_generator(gen, out, writer=writer, finish=False)
        finally:
            gen.stop()
    extra = {"model_dir": model_dir} if model_dir else {}
    if buckets or model_dir:
        from paddle_tpu_torch.serving.batching import bucket_ladder

        extra["buckets"] = list(buckets or bucket_ladder(max_batch))
    manifest = writer.finish(extra=extra or None)
    total = sum(e["nbytes"] for e in writer.entries.values())
    lib_bytes = sum(k["nbytes"] for k in writer.kernels.values())
    print(f"exported {len(writer.entries)} plan(s), {total} bytes, and "
          f"{len(writer.kernels)} kernel librar"
          f"{'y' if len(writer.kernels) == 1 else 'ies'}, {lib_bytes} "
          f"bytes -> {manifest}")
    for e in sorted(writer.entries.values(), key=lambda e: e["id"]):
        print(f"  {e['id']}  fp={e['program_fp'][:12]}  sig={e['feed_sig']}"
              f"  captures={e['captures']}  {e['nbytes']}B")
    for name, k in sorted(writer.kernels.items()):
        print(f"  kernel {name}: {k['file']}  {k['nbytes']}B")
    return 0


def smoke(place=None) -> int:
    """Export -> an artifact-booted server -> one request -> parity with
    the plan-booted one, in throwaway directories."""
    import tempfile
    import urllib.request

    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import InferenceServer

    def _predict(srv, body):
        req = urllib.request.Request(
            f"http://{srv.address}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    with tempfile.TemporaryDirectory(prefix="paddle_aot_smoke_") as tmp:
        model_dir = os.path.join(tmp, "model")
        art_dir = os.path.join(tmp, "artifacts")
        pt.framework.reset_default_programs()
        x = pt.layers.data(name="x", shape=[6], dtype="float32")
        h = pt.layers.fc(input=x, size=16, act="relu")
        pred = pt.layers.fc(input=h, size=4, act="softmax")
        exe = pt.Executor(place)
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(model_dir, ["x"], [pred], exe)

        writer = export_model(model_dir, art_dir, max_batch=4, place=place)
        print(f"smoke: exported {len(writer.entries)} plans and "
              f"{len(writer.kernels)} kernel libraries")
        body = json.dumps(
            {"x": np.linspace(-1.0, 1.0, 18).reshape(3, 6).tolist()}
        ).encode()
        plan_srv = InferenceServer(model_dir, max_batch=4, warmup=True,
                                   place=place)
        try:
            plan_bytes = _predict(plan_srv, body)
        finally:
            plan_srv.stop()
        aot_srv = InferenceServer(model_dir, max_batch=4, warmup=True,
                                  place=place, artifacts=art_dir)
        try:
            aot_bytes = _predict(aot_srv, body)
            results = dict(aot_srv._artifact_store.results)
            boot = aot_srv._pool.boot_source()
        finally:
            aot_srv.stop()
    if aot_bytes != plan_bytes:
        print("smoke FAIL: the artifact-booted /predict reply differs from "
              f"the plan-booted one ({aot_bytes!r} != {plan_bytes!r})",
              file=sys.stderr)
        return 1
    if boot != "aot" or not results.get("loaded"):
        print(f"smoke FAIL: expected an artifact boot, got boot={boot!r} "
              f"store results={results}", file=sys.stderr)
        return 1
    rejected = {k: v for k, v in results.items() if k.startswith("rejected")}
    if rejected:
        print(f"smoke FAIL: artifact lookups rejected: {rejected}",
              file=sys.stderr)
        return 1
    print(f"smoke OK: boot={boot} store={results} parity=bit-identical")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
