"""Serve a save_inference_model export and/or a paged-KV decoder over
HTTP:

    python -m paddle_tpu_torch.serving --model_dir=DIR [--port=N]
        [--replicas=N] [--max_batch=N] [--batch_timeout_ms=MS] [--warmup]
        [--request_timeout=SECONDS] [--max_inflight=N] [--cpu]
        [--tenants=NAME:RATE[:BURST[:WEIGHT]],...] [--tenant_config=FILE]
        [--max_attempts=N] [--replica_heartbeat_ms=MS]
        [--dispatch_timeout=SECONDS] [--chaos=KIND[@N[:rIDX]]]
        [--artifacts=DIR]
    python -m paddle_tpu_torch.serving --gen_config=SCRIPT [--port=N]
        [--gen_pages=N] [--gen_page_size=N] [--gen_pages_per_seq=N]
        [--gen_slots=N] [--gen_queue=N] [--gen_max_tokens=N]
        [--prefix_cache] [--prefix_cache_pages=N] [--spec_draft=ngram]
        [--spec_k=K] [--beam_max=K] [--request_timeout=SECONDS]

The counterpart of ``paddle serve``.  ``--model_dir`` mounts
``/predict``, on CUDA card 0 unless ``--cpu`` is given.  ``--tenants``
gives each named tenant a token-bucket quota and a fair-queue weight
(a ``*`` entry templates unknown tenants); ``--tenant_config`` reads the
same from a JSON file (``{"A": {"rate": 100, "burst": 20, "weight":
4}, ...}``) or from a file of one ``NAME:RATE...`` entry a line.
``--chaos`` arms a fault injector after warmup (``die``, ``raise`` or
``hang`` on the Nth dispatch).  ``--artifacts=DIR`` boots the replicas
from a ``paddle compile`` directory (``paddle_tpu_torch.aot``): run plans
from its records and kernel libraries from its files, a loud fallback on
any mismatch.
``--gen_config`` mounts ``/generate``: SCRIPT is executed and must
define ``make_decode_model()`` returning a paged decoder LM (a
``paddle_tpu_torch.decode.model.TinyDecoderLM``, which picks its own
place), or ``make_generator()`` returning ``(beam_gen, parameters)``, a
v1 ``beam_search`` spec and its trained parameters (served by
``GenerationEngine.for_seq2seq`` on the card, or on the CPU under
``--cpu``; ``paddle_tpu_torch/demos/seq2seq/gen_config.py`` is one); a
``make_draft_model()`` in it, or ``--spec_draft=ngram``, turns on
speculative decoding.  Prints one line
``serving on http://HOST:PORT`` once it accepts requests, then serves
until SIGTERM or SIGINT, and exits 0.  ``--use_gpu=0`` is ``--cpu``.

``paddle serve`` (``python -m paddle_tpu_torch.cli serve``) parses the
same flags through ``serve_parser`` and builds the same server through
``make_server``.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading

from paddle_tpu_torch.framework import CPUPlace, CUDAPlace, default_place
from paddle_tpu_torch.serving import InferenceServer


def load_generator(args):
    """A GenerationEngine from ``--gen_config`` and the ``--gen_*``
    flags (``paddle_tpu/cli.py`` ``_load_generator``): the script's
    ``make_decode_model()`` (a paged decoder LM), else its
    ``make_generator() -> (beam_gen, parameters)`` (a v1 ``beam_search``
    spec, served by ``GenerationEngine.for_seq2seq`` over
    ``--gen_pages`` pages of ``--gen_page_size`` rows, at most
    ``--gen_pages_per_seq`` a sequence; without ``--gen_max_tokens`` a
    request's budget is the spec's ``max_length``).  ``make_generator``
    and the engine run on the card, or on the CPU under ``--cpu`` /
    ``--use_gpu=0`` (the script's entry points that take no place follow
    ``framework.default_place``)."""
    from paddle_tpu_torch.decode import GenerationEngine
    from paddle_tpu_torch.decode.spec import NgramDraft

    path = args.gen_config
    glb = {"__file__": path, "__name__": "__paddle_serve_gen__"}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), glb)
    spec_draft = None
    if "make_draft_model" in glb:
        spec_draft = glb["make_draft_model"]()
    elif args.spec_draft == "ngram":
        spec_draft = NgramDraft()
    if "make_decode_model" in glb:
        return GenerationEngine(
            glb["make_decode_model"](), max_slots=args.gen_slots,
            max_waiting=args.gen_queue,
            max_new_tokens=(args.gen_max_tokens
                            if args.gen_max_tokens is not None else 32),
            prefix_cache=args.prefix_cache,
            prefix_cache_pages=args.prefix_cache_pages,
            spec_draft=spec_draft, spec_k=args.spec_k,
            beam_max=args.beam_max)
    if "make_generator" not in glb:
        raise RuntimeError(
            f"{path} defines no make_generator() -> (beam_gen, parameters) "
            "and no make_decode_model() -> paged decoder model")
    cpu = getattr(args, "cpu", False) or not getattr(args, "use_gpu", 1)
    place = CPUPlace() if cpu else CUDAPlace(0)
    with default_place(place):
        beam_gen, parameters = glb["make_generator"]()
        return GenerationEngine.for_seq2seq(
            beam_gen, parameters, num_pages=args.gen_pages,
            page_size=args.gen_page_size,
            pages_per_seq=args.gen_pages_per_seq,
            max_slots=args.gen_slots, max_waiting=args.gen_queue,
            max_new_tokens=args.gen_max_tokens, beam_max=args.beam_max,
            place=place)


def tenant_spec(args):
    """``--tenant_config``'s JSON dict, or its ``NAME:RATE...`` lines (one
    entry a line, ``#`` lines skipped, as ``paddle serve`` reads them)
    joined as a ``--tenants`` spec; else ``--tenants``."""
    if not args.tenant_config:
        return args.tenants
    with open(args.tenant_config) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return ",".join(ln.strip() for ln in text.splitlines()
                        if ln.strip() and not ln.startswith("#"))


def serve_parser(prog: str, port: int = 8000) -> argparse.ArgumentParser:
    """The serving flags of ``paddle serve`` and of this launcher."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--model_dir", default=None)
    ap.add_argument("--port", type=int, default=port)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--batch_timeout_ms", type=float, default=0.0)
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--request_timeout", type=float, default=None)
    ap.add_argument("--max_inflight", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run /predict on the CPU instead of CUDA card 0")
    ap.add_argument("--use_gpu", type=int, default=1,
                    help="1: CUDA card 0; 0: the CPU (as --cpu)")
    ap.add_argument("--tenants", default=None,
                    help="NAME:RATE[:BURST[:WEIGHT]],... token-bucket "
                    "quotas and fair-queue weights")
    ap.add_argument("--tenant_config", default=None,
                    help="a JSON file of tenants, or one spec a line")
    ap.add_argument("--max_attempts", type=int, default=3)
    ap.add_argument("--replica_heartbeat_ms", type=float, default=1000.0)
    ap.add_argument("--dispatch_timeout", type=float, default=None)
    ap.add_argument("--chaos", default=None,
                    help="KIND[@N[:rIDX]]: die, raise or hang on the Nth "
                    "dispatch after warmup")
    ap.add_argument("--artifacts", default=None,
                    help="a `paddle compile` directory to boot the "
                    "replicas from (AOT run plans and kernel libraries)")
    ap.add_argument("--gen_config", default=None,
                    help="script defining make_decode_model() or "
                    "make_generator(): mounts POST /generate")
    ap.add_argument("--gen_pages", type=int, default=64,
                    help="make_generator(): pages in the context pool")
    ap.add_argument("--gen_page_size", type=int, default=8,
                    help="make_generator(): rows a page")
    ap.add_argument("--gen_pages_per_seq", type=int, default=2,
                    help="make_generator(): pages a sequence at most")
    ap.add_argument("--gen_slots", type=int, default=8)
    ap.add_argument("--gen_queue", type=int, default=64)
    ap.add_argument("--gen_max_tokens", type=int, default=None,
                    help="a request's token budget: 32 for "
                    "make_decode_model(), the spec's max_length for "
                    "make_generator()")
    ap.add_argument("--prefix_cache", action="store_true")
    ap.add_argument("--prefix_cache_pages", type=int, default=None)
    ap.add_argument("--spec_draft", choices=("ngram",), default=None)
    ap.add_argument("--spec_k", type=int, default=4)
    ap.add_argument("--beam_max", type=int, default=0)
    return ap


def parse_serve_args(ap: argparse.ArgumentParser, argv=None):
    args = ap.parse_args(argv)
    if args.model_dir is None and args.gen_config is None:
        ap.error("give --model_dir and/or --gen_config")
    return args


def make_server(args) -> InferenceServer:
    """The server the parsed flags describe."""
    generator = load_generator(args) if args.gen_config else None
    cpu = args.cpu or not args.use_gpu
    return InferenceServer(
        args.model_dir, port=args.port, host=args.host,
        request_timeout=args.request_timeout,
        max_inflight=args.max_inflight, replicas=args.replicas,
        max_batch=args.max_batch, batch_timeout_ms=args.batch_timeout_ms,
        warmup=args.warmup, place=CPUPlace() if cpu else None,
        generator=generator, tenants=tenant_spec(args),
        max_attempts=args.max_attempts,
        replica_heartbeat_ms=args.replica_heartbeat_ms,
        dispatch_timeout=args.dispatch_timeout, chaos=args.chaos,
        artifacts=args.artifacts)


def serve_until_signalled(srv) -> int:
    """Serve until SIGTERM or SIGINT, then stop the server: exit code 0."""
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: done.set())
    signal.signal(signal.SIGINT, lambda *a: done.set())
    done.wait()
    srv.stop()
    return 0


def main(argv=None) -> int:
    args = parse_serve_args(serve_parser("python -m paddle_tpu_torch.serving"),
                            argv)
    srv = make_server(args)
    print(f"serving on http://{srv.address}", flush=True)
    return serve_until_signalled(srv)


if __name__ == "__main__":
    raise SystemExit(main())
