"""The ``paddle`` command of the port (``paddle_tpu/cli.py``), run as
``python -m paddle_tpu_torch.cli <command>``.

Commands:
  train --config=conf.py [--num_passes=N] [--save_dir=D] [--config_args=k=v,...]
        [--job=train|test|checkgrad] [--use_gpu=0] ...
      (the v1 trainer, ``paddle_tpu_torch.trainer.main``)
  version
      (the port's, torch's and CUDA's versions and the cards; runs nothing)
  merge_model --model_dir=DIR --out=OUT_DIR [--config=conf.py]
              [--config_args=...] [--use_gpu=0]
      (re-parse the v1 config, load the latest pass's params.tar, write a
       save_inference_model directory)
  serve [--model_dir=DIR] [--port=N] [--replicas=N] [--max_batch=N]
        [--batch_timeout_ms=MS] [--warmup] [--request_timeout=SECONDS]
        [--max_inflight=N] [--tenants=...] [--tenant_config=FILE]
        [--max_attempts=N] [--replica_heartbeat_ms=MS]
        [--dispatch_timeout=S] [--chaos=KIND[@N[:rIDX]]] [--use_gpu=0|--cpu]
        [--gen_config=SCRIPT --gen_pages=N --gen_page_size=N
         --gen_pages_per_seq=N --gen_slots=N --gen_queue=N --gen_max_tokens=N
         --beam_max=K --prefix_cache --prefix_cache_pages=N
         --spec_draft=ngram --spec_k=N]
      (HTTP inference over a save_inference_model export and/or a paged-KV
       decoder, ``paddle_tpu_torch.serving``; the flags of
       ``python -m paddle_tpu_torch.serving``.  Prints "inference server
       listening on HOST:PORT", serves until SIGTERM or SIGINT, exits 0)
  lint <program.json|config.py> [--level=...] [--strict] [--json]
       [--fetch=a,b] [--feed=a,b] [--optimize] | lint --audit-registry
      (static program verification, ``paddle_tpu_torch.analysis``; exits
       1 on error diagnostics, 2 on a target it cannot analyze)
  stats [--json] [--run=script.py [--use_gpu=0]] [--file=telemetry.json]
        [--url=http://host:port] [--trace=out.json]
      (the telemetry registry, ``paddle_tpu_torch.observability``, as a
       table or JSON)
  compile --model_dir=DIR --out=DIR [--max_batch=N] [--buckets=1,2,4]
          [--no-optimize] [--cpu] [--gen_config=SCRIPT ...] | compile --smoke
      (AOT serving artifacts, ``paddle_tpu_torch.aot``: the run plans of
       the bucket ladder and the kernel libraries under a versioned
       manifest, for ``serve --artifacts=DIR``; exits 2 on a usage error)
  tune [--kernel=softmax,matmul,...] [--shapes=RxC;...] [--budget=N]
       [--reps=N] [--dtype=float32] [--output=PATH] [--telemetry=PATH]
       [--seed=N] [--smoke]
      (the kernel tuner, ``paddle_tpu_torch.kernels.tuning``: time each
       family's launch candidates on the card, held against the plain
       versions, and merge the winners into the tuning database dispatch
       reads; exits 2 on an unknown kernel, 1 without a card)
  pserver, master, coord, elastic
      (not ported yet: each prints the ROADMAP step that brings it and
       exits 1)

The commands that run a program (train, merge_model, serve, compile,
stats --run) run it on CUDAPlace(0) and raise where no card is found;
``--use_gpu=0`` runs it on the CPU.
"""

import os
import sys


def _kv_args(argv):
    out = {}
    rest = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            out[k] = v
        else:
            rest.append(a)
    return out, rest


def _place(args):
    """CUDAPlace(0), or the CPU under ``--use_gpu=0``."""
    from paddle_tpu_torch.framework import CPUPlace, CUDAPlace

    return CPUPlace() if args.get("use_gpu", "1") in ("0", "false") \
        else CUDAPlace(0)


def cmd_version(_):
    import torch

    import paddle_tpu_torch

    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__}")
    print(f"  torch {torch.__version__}; CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"  {torch.cuda.get_device_name(0)} x{n}")
    else:
        print("  no CUDA device")
    return 0


def _cwd_importable():
    # v1 config files import their own package tree relative to the
    # invocation directory
    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())


def cmd_train(argv):
    _cwd_importable()
    from paddle_tpu_torch.trainer.trainer import main as trainer_main

    return trainer_main(argv)


def cmd_merge_model(argv):
    _cwd_importable()
    args, _ = _kv_args(argv)
    model_dir = args.get("model_dir")
    out = args.get("out")
    if not model_dir or not out:
        print("usage: paddle merge_model --model_dir=DIR --out=OUT_DIR",
              file=sys.stderr)
        return 2
    config = args.get("config") or os.path.join(model_dir, "trainer_config.py")
    from paddle_tpu_torch.trainer.config_parser import parse_config
    from paddle_tpu_torch.trainer.trainer import Trainer

    conf = parse_config(config, args.get("config_args", ""))
    t = Trainer(conf, _place(args))
    t.load_parameters(model_dir)
    t.export_inference_model(out)
    print(f"merged model written to {out}")
    return 0


def cmd_serve(argv):
    """``paddle serve``: the launcher's flags (``serving/__main__.py``
    ``serve_parser``), port 0 unless given."""
    from paddle_tpu_torch.serving.__main__ import (make_server,
                                                   parse_serve_args,
                                                   serve_parser,
                                                   serve_until_signalled)

    try:
        args = parse_serve_args(serve_parser("paddle serve", port=0), argv)
    except SystemExit as e:   # a usage error: argparse printed it
        return e.code
    srv = make_server(args)
    print(f"inference server listening on {srv.address}", flush=True)
    return serve_until_signalled(srv)


def cmd_compile(argv):
    """``paddle compile``: AOT serving artifacts (``aot/compile_cli.py``)."""
    from paddle_tpu_torch.aot.compile_cli import main as compile_main

    return compile_main(argv)


def cmd_tune(argv):
    """``paddle tune``: the kernel tuner (``kernels/tuning/tune.py``)."""
    from paddle_tpu_torch.kernels.tuning.tune import main as tune_main

    return tune_main(argv)


_LATER = {
    "pserver": "the parameter server comes with ROADMAP Queue 1 item 3 "
               "step 6",
    "master": "the master service comes with ROADMAP Queue 1 item 3 step 6",
    "coord": "the coordination service comes with ROADMAP Queue 1 item 3 "
             "step 6",
    "elastic": "elastic training comes with ROADMAP Queue 1 item 3 step 6",
}


def _not_yet(name):
    def cmd(_argv):
        print(f"paddle {name}: not in paddle_tpu_torch yet; {_LATER[name]}",
              file=sys.stderr)
        return 1

    cmd.__name__ = f"cmd_{name}"
    return cmd


def _lint_load(target, config_args=""):
    """A lint target as (program, feed_names|None, fetch_names|None).

    ``*.json``: a save_inference_model ``__model__.json`` (program and
    feed/fetch lists) or a bare ``Program.to_dict`` dump.  ``*.py``: a v1
    trainer config (parsed and built into a Program through Topology) or
    a fluid script that builds the default main program when run.
    """
    import json

    from paddle_tpu_torch import framework

    if target.endswith(".json"):
        with open(target) as f:
            meta = json.load(f)
        if "program" in meta:
            feeds = meta.get("feed_names")
            return (framework.Program.from_dict(meta["program"]),
                    set(feeds) if feeds is not None else None,
                    meta.get("fetch_names") or None)
        return framework.Program.from_dict(meta), None, None

    _cwd_importable()
    v1_err = None
    try:
        from paddle_tpu_torch.trainer.config_parser import parse_config
        from paddle_tpu_torch.v2.topology import Topology

        conf = parse_config(target, config_args)
        if conf.cost is not None:
            topo = Topology(conf.cost, extra_layers=conf.evaluators)
            fetches = [v.name for v in topo.output_vars]
            return topo.main_program, set(topo.feed_names()), fetches
    except Exception as e:
        v1_err = e  # remember; it may be a fluid script instead
    main, startup = framework.Program(), framework.Program()
    try:
        with framework.program_guard(main, startup):
            glb = {"__file__": target, "__name__": "__paddle_lint__"}
            with open(target) as f:
                exec(compile(f.read(), target, "exec"), glb)
    except Exception as e:
        if v1_err is not None:
            raise RuntimeError(
                f"not a v1 config ({type(v1_err).__name__}: {v1_err}) "
                f"nor a fluid script ({type(e).__name__}: {e})") from e
        raise
    if v1_err is not None and not any(b.ops for b in main.blocks):
        # it ran but built nothing: the v1 parse error is the diagnostic
        raise RuntimeError(
            f"v1 config parse failed: {type(v1_err).__name__}: {v1_err}")
    return main, None, None


def cmd_lint(argv):
    """paddle lint <program.json|config.py> [--level=warning] [--strict]
    [--json] [--fetch=a,b] [--feed=a,b] [--optimize]
    | paddle lint --audit-registry

    Run the static verifier (``paddle_tpu_torch.analysis``) and print its
    diagnostics.  Exit 1 when errors fire (or warnings, with --strict).
    ``--optimize`` also dry-runs the whole-program optimizer over each
    target, prints its report and verifies the rewritten program again;
    ``--audit-registry`` checks op metadata against the port's
    ``analysis/registry_baseline.json``.
    """
    import json as json_mod

    from paddle_tpu_torch import analysis

    args, rest = _kv_args(argv)
    flags = {a for a in rest if a.startswith("--")}
    targets = [a for a in rest if not a.startswith("--")]
    as_json = "--json" in flags
    strict = "--strict" in flags
    do_optimize = "--optimize" in flags

    audit = "--audit-registry" in flags or bool(args.get("audit-registry"))
    diags = []
    if audit:
        diags.extend(analysis.audit_registry())
    if not targets and not audit:
        print("usage: paddle lint <program.json|config.py> "
              "[--level=error|warning|all] [--strict] [--json] "
              "[--fetch=a,b] [--feed=a,b] [--audit-registry]",
              file=sys.stderr)
        return 2

    level = args.get("level", "warning")
    if level not in ("error", "warning", "info", "all"):
        print(f"bad --level={level}; one of error|warning|info|all",
              file=sys.stderr)
        return 2
    unusable = False  # a bad target never downgrades to "clean"
    opt_reports = []  # (target, OptReport) pairs under --optimize
    for target in targets:
        if not os.path.exists(target):
            print(f"lint target not found: {target}", file=sys.stderr)
            unusable = True
            continue
        try:
            program, feeds, fetches = _lint_load(target,
                                                 args.get("config_args", ""))
        except Exception as e:
            print(f"cannot load lint target {target}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            unusable = True
            continue
        if not any(b.ops for b in program.blocks):
            print(f"lint target {target} built an empty program "
                  "(no ops); nothing to analyze", file=sys.stderr)
            unusable = True
            continue
        if args.get("feed"):
            feeds = set(args["feed"].split(","))
        if args.get("fetch"):
            fetches = args["fetch"].split(",")
        diags.extend(analysis.verify_program(
            program, feed_names=feeds, fetch_names=fetches, level=level))
        if do_optimize:
            optimized, report = analysis.optimize_program(
                program, feed_names=feeds, fetch_names=fetches)
            opt_reports.append((target, report))
            # every pass is verified or reverted, so an error here is a
            # fault of that gate: report it, never a broken rewrite
            diags.extend(analysis.verify_program(
                optimized, feed_names=feeds, fetch_names=fetches,
                level="error"))

    if as_json:
        doc = [d.to_dict() for d in diags]
        if do_optimize:
            doc = {"diagnostics": doc,
                   "optimize": {t: r.to_dict() for t, r in opt_reports}}
        print(json_mod.dumps(doc, indent=1))
    elif diags or not unusable:  # no "clean" claim if nothing was analyzed
        for target, report in opt_reports:
            print(f"== optimize: {target}")
            print(report.format())
        print(analysis.format_report(diags))
    if unusable:
        return 2
    bad = [d for d in diags if d.severity == analysis.Severity.ERROR
           or (strict and d.severity == analysis.Severity.WARNING)]
    return 1 if bad else 0


def cmd_stats(argv):
    """paddle stats [--json] [--run=script.py [--use_gpu=0]]
    [--file=artifact.json] [--url=http://host:port] [--trace=out.json]

    The telemetry registry (``paddle_tpu_torch.observability``) as a
    table or JSON, from, in this order: a live server's ``/stats``
    (--url), a telemetry artifact (--file), or this process's registry,
    after running a fluid script (--run; its ``Executor()`` on the card,
    or on the CPU with --use_gpu=0).  --trace also writes the host event
    ring as Chrome-trace JSON.
    """
    import json as json_mod

    from paddle_tpu_torch import observability as obs

    args, rest = _kv_args(argv)
    as_json = "--json" in rest
    if args.get("trace") and args.get("url"):
        print("--trace: host events live in the server process and are "
              "not exported over /stats; run paddle stats --trace "
              "in-process instead", file=sys.stderr)
        return 2
    if args.get("url"):
        import urllib.request

        url = args["url"].rstrip("/") + "/stats"
        with urllib.request.urlopen(url, timeout=30) as r:
            snap = json_mod.loads(r.read())
    elif args.get("file"):
        with open(args["file"]) as f:
            data = json_mod.load(f)
        # a telemetry artifact nests the registry under "metrics"; a raw
        # snapshot dump is the registry
        snap = data.get("metrics", data) or {}
    else:
        if args.get("run"):
            from paddle_tpu_torch.framework import default_place

            _cwd_importable()
            path = args["run"]
            glb = {"__file__": path, "__name__": "__paddle_stats__"}
            with open(path) as f, default_place(_place(args)):
                exec(compile(f.read(), path, "exec"), glb)
        snap = obs.snapshot()
    if as_json:
        print(json_mod.dumps(snap, indent=1, sort_keys=True))
    else:
        table = obs.format_snapshot(snap)
        print(table if table else
              "telemetry registry is empty (no metrics recorded)")
    if args.get("trace"):
        if args.get("file"):
            # an artifact embeds its run's Chrome trace: export that, not
            # this process's (empty) event ring
            trace = data.get("events")
            if not trace:
                print(f"--trace: {args['file']} carries no embedded "
                      "host events", file=sys.stderr)
                return 2
            with open(args["trace"], "w") as f:
                json_mod.dump(trace, f)
        else:
            obs.export_chrome_trace(args["trace"])
        print(f"host events written to {args['trace']} "
              "(chrome://tracing)", file=sys.stderr)
    return 0


COMMANDS = {
    "train": cmd_train,
    "version": cmd_version,
    "merge_model": cmd_merge_model,
    "compile": cmd_compile,
    "serve": cmd_serve,
    "lint": cmd_lint,
    "stats": cmd_stats,
    "tune": cmd_tune,
    "pserver": _not_yet("pserver"),
    "master": _not_yet("master"),
    "coord": _not_yet("coord"),
    "elastic": _not_yet("elastic"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r}; one of {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return cmd(argv[1:])


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
