"""Serve a save_inference_model export over HTTP:

    python -m paddle_tpu_torch.serving --model_dir=DIR [--port=N]
        [--replicas=N] [--max_batch=N] [--batch_timeout_ms=MS] [--warmup]
        [--request_timeout=SECONDS] [--max_inflight=N] [--cpu]

The counterpart of ``paddle serve``.  Runs on CUDA card 0 unless
``--cpu`` is given.  Prints one line ``serving on http://HOST:PORT``
once it accepts requests, then serves until interrupted.
"""

from __future__ import annotations

import argparse
import threading

from paddle_tpu_torch.framework import CPUPlace
from paddle_tpu_torch.serving import InferenceServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.serving")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--batch_timeout_ms", type=float, default=0.0)
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--request_timeout", type=float, default=None)
    ap.add_argument("--max_inflight", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of CUDA card 0")
    args = ap.parse_args(argv)
    srv = InferenceServer(
        args.model_dir, port=args.port, host=args.host,
        request_timeout=args.request_timeout,
        max_inflight=args.max_inflight, replicas=args.replicas,
        max_batch=args.max_batch, batch_timeout_ms=args.batch_timeout_ms,
        warmup=args.warmup, place=CPUPlace() if args.cpu else None)
    print(f"serving on http://{srv.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
