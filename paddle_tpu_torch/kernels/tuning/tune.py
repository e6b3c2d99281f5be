"""``paddle tune``: measure the kernels' launch candidates on the card and
write the winners into a tuning database (``paddle_tpu/pallas/tuning/
tune.py``).

For every chosen family and shape it lists the candidates (``space.py``),
times the wrapper's own choice and up to ``--budget`` candidates (a seeded
sample past the budget), each first held against the kernel's plain
version (``measure.py``), and merges the winner into the database (an
atomic write).  It prints a tuned-against-default table and writes a
``paddle_tpu.tune.v1`` telemetry artifact.  It runs on CUDA card 0 and
exits 1 without one: it times kernels, never their plain versions.

Flags (``--k=v``, the repo's convention):

  --kernel=softmax,matmul   families (default: all)
  --shapes=8x1000;2048x30000
                            shapes (default: each family's
                            ``default_shapes``; dims 'x'-joined, shapes
                            ';'-separated)
  --budget=N                most candidates timed a (kernel, shape)
                            (default 32)
  --reps=N                  timed samples a point, median (default 5)
  --dtype=float32           operand dtype (float32, bfloat16 where the
                            family takes it)
  --output=PATH             the database (default: the shipped
                            ``tuning_db.json``)
  --telemetry=PATH          the artifact (default: ``<output>`` with
                            ``.telemetry.json``)
  --seed=N                  the candidates' sample and the inputs' seed
  --smoke                   tiny shapes, budget 2, 2 samples
"""

from __future__ import annotations

import json
import random
import sys
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.kernels.tuning import db as _dbmod
from paddle_tpu_torch.kernels.tuning.db import TuningDB


def _parse_shapes(spec: str):
    shapes = []
    for part in spec.split(";"):
        part = part.strip()
        if part:
            shapes.append(tuple(int(d) for d in part.split("x")))
    return shapes


def tune_one(family, shape, dtype: str, budget: int, reps: int,
             device, device_kind: str, seed: int = 0, log=print,
             measure: Optional[Callable] = None,
             sms: int = 132) -> Optional[dict]:
    """Time one (family, shape) point: the default, then the (sampled)
    candidates.  Returns the database record (None where the default
    itself is infeasible).  ``measure(family, case, shape, dtype, cfg,
    device_kind, reps) -> (ms, err)`` raises ``measure.Infeasible``
    (the card's ``measure_config`` unless given)."""
    from paddle_tpu_torch.kernels.tuning import measure as _measure
    from paddle_tpu_torch.observability import metrics

    measure = measure or _measure.measure_config
    m_measured = metrics.counter(
        "tune_configs_measured_total",
        "tuner candidate configs timed")
    m_infeasible = metrics.counter(
        "tune_configs_infeasible_total",
        "tuner candidate configs that failed to launch or left the "
        "kernel's tolerance against its plain version")
    cands = family.configs(shape, dtype, sms)
    n_space = len(cands)
    if budget and len(cands) > budget:
        cands = random.Random(seed).sample(cands, budget)
    case = family.build(shape, dtype, device, seed)
    try:
        default_ms, default_err = measure(family, case, shape, dtype, None,
                                          device_kind, reps)
    except _measure.Infeasible as e:
        log(f"  {family.name}{shape}: the default is infeasible ({e}); "
            "skipped")
        return None
    best_cfg, best_ms, best_err, n_inf = None, float("inf"), None, 0
    for cfg in cands:
        try:
            ms, err = measure(family, case, shape, dtype, cfg, device_kind,
                              reps)
            m_measured.inc(kernel=family.name)
        except _measure.Infeasible as e:
            n_inf += 1
            m_infeasible.inc(kernel=family.name)
            log(f"  {family.name}{shape} {cfg}: infeasible ({e})")
            continue
        if ms < best_ms:
            best_cfg, best_ms, best_err = cfg, ms, err
    if best_cfg is None or best_ms >= default_ms:
        # nothing beat the default: record the default itself, so that
        # dispatch stays on it and the entry says so
        best_cfg, best_ms, best_err = None, default_ms, default_err
    return {
        "config": best_cfg or {},
        "time_ms": round(best_ms, 6),
        "default_time_ms": round(default_ms, 6),
        "speedup": round(default_ms / best_ms, 4) if best_ms else 1.0,
        "max_abs_err": best_err,
        "n_configs": n_space,
        "n_measured": len(cands),
        "n_infeasible": n_inf,
        "shape": list(shape),
    }


def run_tune(names: List[str], shapes_flag, smoke: bool, budget: int,
             reps: int, dtype: str, seed: int, out_path: str, device,
             device_kind: str, measure: Optional[Callable] = None,
             sms: int = 132, log=print):
    """The loop of ``paddle tune``: enumerate, measure, persist, look up.
    Returns (rows, saved path, hits) or raises ValueError on a shape of
    the wrong rank or a dtype the family does not take."""
    from paddle_tpu_torch.kernels import tuning
    from paddle_tpu_torch.kernels.tuning import space

    # measure against the wrappers' own choices, not an installed DB
    tuning.disable()
    new_db = TuningDB()
    rows = []
    for name in names:
        family = space.SPACES[name]
        if dtype not in family.dtypes:
            raise ValueError(f"{name} takes dtypes {family.dtypes}, not "
                             f"{dtype}")
        shapes = shapes_flag or (family.smoke_shapes if smoke
                                 else family.default_shapes)
        for shape in shapes:
            if len(shape) != len(family.shape_names):
                raise ValueError(f"{name} wants dims "
                                 f"{'x'.join(family.shape_names)}, got "
                                 f"{shape}")
            rec = tune_one(family, shape, dtype, budget, reps, device,
                           device_kind, seed, log, measure, sms)
            if rec is None:
                continue
            new_db.put(name, shape, dtype, device_kind, rec)
            rows.append({"kernel": name, "shape": list(shape),
                         "dtype": dtype, **{k: rec[k] for k in (
                             "config", "time_ms", "default_time_ms",
                             "speedup", "max_abs_err", "n_configs",
                             "n_measured", "n_infeasible")}})
            log(json.dumps({"kernel": name,
                            "shape": "x".join(map(str, shape)),
                            "default_ms": rec["default_time_ms"],
                            "tuned_ms": rec["time_ms"],
                            "speedup": rec["speedup"],
                            "config": rec["config"],
                            "configs": rec["n_configs"],
                            "measured": rec["n_measured"],
                            "infeasible": rec["n_infeasible"]}))
    saved = new_db.save(out_path, merge_existing=True)
    # the round trip: the saved DB serves dispatch hits
    tuning.set_db(saved)
    hits = sum(1 for r in rows if tuning.lookup(
        r["kernel"], r["shape"], r["dtype"], device_kind) is not None)
    return rows, saved, hits


def _artifact(path: str, rows, db_path: str, device_kind: str):
    import torch

    from paddle_tpu_torch import observability as obs

    art = {
        "schema": "paddle_tpu.tune.v1",
        "db_path": db_path,
        "device": {
            "backend": "cuda",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "db_device_kind": device_kind,
        },
        "results": rows,
        "metrics": obs.snapshot(),
    }
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
        f.write("\n")
    return path


def _table(rows) -> str:
    from paddle_tpu_torch.observability.metrics import format_table

    return format_table(
        [("kernel", "shape", "dtype", "default ms", "tuned ms", "speedup",
          "config", "configs", "infeasible")]
        + [(r["kernel"], "x".join(map(str, r["shape"])), r["dtype"],
            f"{r['default_time_ms']:.6f}", f"{r['time_ms']:.6f}",
            f"{r['speedup']:.4f}", json.dumps(r["config"]),
            str(r["n_configs"]), str(r["n_infeasible"])) for r in rows])


def main(argv) -> int:
    from paddle_tpu_torch.kernels.tuning import space

    kv, rest = _cli_kv(argv)
    if rest:
        print(f"tune: unexpected args {rest}", file=sys.stderr)
        return 2
    smoke = "smoke" in kv
    try:
        budget = int(kv.get("budget", 2 if smoke else 32))
        reps = int(kv.get("reps", 2 if smoke else 5))
        seed = int(kv.get("seed", 0))
        shapes_flag = (_parse_shapes(kv["shapes"]) if "shapes" in kv
                       else None)
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    dtype = kv.get("dtype", "float32")
    out_path = kv.get("output", _dbmod.DEFAULT_PATH)
    names = [n for n in kv.get("kernel", "").split(",") if n]
    if not names:
        names = sorted(space.SPACES)
    unknown = [n for n in names if n not in space.SPACES]
    if unknown:
        print(f"tune: unknown kernel(s) {unknown}; one of "
              f"{sorted(space.SPACES)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("tune: needs a CUDA card (torch finds none): the tuner times "
              "the kernels on the card and never their plain versions",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    device_kind = _dbmod.current_device_kind()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"tune: kernels={names} budget={budget} reps={reps} dtype={dtype} "
          f"on {torch.cuda.get_device_name(0)} -> {out_path}")
    try:
        rows, saved, hits = run_tune(names, shapes_flag, smoke, budget, reps,
                                     dtype, seed, out_path, device,
                                     device_kind, sms=sms)
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    print(_table(rows))
    print(f"tune: {len(rows)} entr{'y' if len(rows) == 1 else 'ies'} "
          f"-> {saved}")
    print(f"tune: dispatch round-trip {hits}/{len(rows)} hits")
    telemetry = kv.get("telemetry",
                       out_path.rsplit(".json", 1)[0] + ".telemetry.json")
    try:
        _artifact(telemetry, rows, saved, device_kind)
        print(f"tune: telemetry artifact -> {telemetry}")
    except Exception as e:   # the artifact never fails the tune
        print(f"tune: telemetry artifact failed: {type(e).__name__}: {e}",
              file=sys.stderr)
    return 0


def _cli_kv(argv):
    """``--k=v`` plus bare ``--flag`` (stored as an empty string)."""
    out: Dict[str, str] = {}
    rest = []
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            out[k] = v
        else:
            rest.append(a)
    return out, rest


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
