"""Registry coverage audit: op metadata can only ratchet up.

Every registered op should carry an ``infer_shape`` rule (the static
verifier's shape/dtype propagation) and declare its input slots.
Ops without them are grandfathered in the port's own checked-in baseline
(``registry_baseline.json``: the port registers fewer ops than the JAX
package, so it ratchets against its own list); the audit errors on any
op that is missing coverage AND absent from the baseline, so new ops
must ship with metadata and the baseline can only shrink.

Regenerate the baseline (after adding coverage) with::

    python -m paddle_tpu_torch.analysis.registry_audit --write-baseline
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from paddle_tpu_torch.registry import OpRegistry
from paddle_tpu_torch.analysis.verify import Diagnostic, Severity

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "registry_baseline.json")

# Keys in the baseline file, paired with the audit predicate they gate.
_CHECKS = (
    ("missing_infer_shape", "PVA01",
     lambda info: info.infer_shape is None,
     "has no infer_shape rule"),
    ("missing_input_slots", "PVA02",
     lambda info: not info.input_slots,
     "declares no input slots"),
)


def current_gaps() -> Dict[str, List[str]]:
    """Ops currently missing each kind of metadata (sorted).

    ``<base>_grad`` entries synthesized on demand from a registered
    forward (autodiff.synthesize_grad_info caches them into the
    registry) are skipped: their metadata is derived from the forward's
    vjp, and auditing them would make results depend on which grad ops
    some earlier program happened to exercise.
    """
    gaps: Dict[str, List[str]] = {key: [] for key, *_ in _CHECKS}
    for name in OpRegistry.all_ops():
        if name.endswith("_grad") and OpRegistry.has(name[: -len("_grad")]):
            continue
        info = OpRegistry.get(name)
        for key, _code, predicate, _msg in _CHECKS:
            if predicate(info):
                gaps[key].append(name)
    return gaps


def load_baseline(path: Optional[str] = None) -> Dict[str, List[str]]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {key: [] for key, *_ in _CHECKS}
    with open(path) as f:
        data = json.load(f)
    return {key: list(data.get(key, [])) for key, *_ in _CHECKS}


def write_baseline(path: Optional[str] = None) -> Dict[str, List[str]]:
    """Snapshot the current gaps as the new allowlist."""
    gaps = current_gaps()
    with open(path or BASELINE_PATH, "w") as f:
        json.dump(gaps, f, indent=1, sort_keys=True)
        f.write("\n")
    return gaps


def audit_registry(baseline: Optional[Dict[str, List[str]]] = None
                   ) -> List[Diagnostic]:
    """Compare current registry coverage against the baseline.

    Errors (PVA01/PVA02): an op is missing metadata and is NOT
    grandfathered — coverage regressed (or a new op shipped without
    metadata).  Info (PVA03): a baseline entry is stale (the op gained
    coverage or was unregistered) — shrink the baseline to lock in the
    gain.
    """
    baseline = load_baseline() if baseline is None else baseline
    gaps = current_gaps()
    diags: List[Diagnostic] = []
    for key, code, _predicate, msg in _CHECKS:
        allowed = set(baseline.get(key, ()))
        for name in gaps[key]:
            if name not in allowed:
                diags.append(Diagnostic(
                    code=code, severity=Severity.ERROR,
                    message=f"op {name!r} {msg} and is not in the "
                            f"{key} baseline",
                    var=name, pass_name="registry-audit",
                    hint="add the metadata to the registration (preferred) "
                         "or regenerate registry_baseline.json"))
        for name in sorted(allowed - set(gaps[key])):
            diags.append(Diagnostic(
                code="PVA03", severity=Severity.INFO,
                message=f"baseline entry {name!r} under {key} is stale "
                        "(op now covered or no longer registered)",
                var=name, pass_name="registry-audit",
                hint="re-run --write-baseline to ratchet coverage"))
    return diags


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--write-baseline", action="store_true",
                        help="snapshot current gaps as the new allowlist")
    args = parser.parse_args(argv)
    import paddle_tpu_torch  # noqa: F401  (registers the op library)

    if args.write_baseline:
        gaps = write_baseline()
        total = sum(len(v) for v in gaps.values())
        print(f"baseline written: {BASELINE_PATH} ({total} entries)")
        return 0
    diags = audit_registry()
    for d in diags:
        print(d.format())
    errs = [d for d in diags if d.severity == Severity.ERROR]
    print(f"registry audit: {len(errs)} regression(s), "
          f"{len(diags) - len(errs)} note(s)")
    return 1 if errs else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
