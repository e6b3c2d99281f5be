"""Static program analysis: verifier, lint passes and the rewrite
pipeline over the Program IR (the port of ``paddle_tpu/analysis``).

A pass manager runs def-before-use, dtype, fetch-reachability,
gradient-pairing, shape and liveness checks over a ``Program`` before
the Executor builds a run plan for it, with the JAX package's
diagnostic codes, severities, locations and messages.  The optimizer
(constant folding, CSE, dead-code elimination) and the donation-safety
analyzer work on the same dataflow facts.

Entry points:

- ``verify_program(program, feed_names, fetch_names, level)`` — run the
  passes, get structured ``Diagnostic`` records.
- ``check_or_raise(...)`` — the error-tier gate ``Executor.run`` uses
  when the ``check_program`` flag is on.
- ``audit_registry()`` — op-metadata coverage ratchet against the
  checked-in ``registry_baseline.json``.
- ``optimize_program(...)`` / ``donation_mask(...)`` — the rewrite
  pipeline ``Executor.run(optimize_program=True)`` uses, and the state
  the Executor updates in place.
"""

from paddle_tpu_torch.analysis.verify import (  # noqa: F401
    Diagnostic,
    PassContext,
    PassInfo,
    PassManager,
    ProgramVerificationError,
    Severity,
    check_or_raise,
    default_pass_manager,
    format_report,
    register_pass,
    verify_program,
)
from paddle_tpu_torch.analysis import dataflow  # noqa: F401
from paddle_tpu_torch.analysis import passes  # noqa: F401  (registers passes)
from paddle_tpu_torch.analysis.optimize import (  # noqa: F401
    DonationEntry,
    OptReport,
    backward_slice,
    check_parity,
    donation_mask,
    optimize_program,
)
from paddle_tpu_torch.analysis.registry_audit import (  # noqa: F401
    audit_registry,
    current_gaps,
    load_baseline,
    write_baseline,
)
