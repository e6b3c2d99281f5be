"""Program verifier core: Diagnostic records + the pass manager.

The port of ``paddle_tpu/analysis/verify.py``.  Passes
(analysis/passes.py) run static checks over a ``Program`` and emit
structured ``Diagnostic`` records; ``check_or_raise`` is the error-tier
gate the Executor runs at a plan-cache miss when the ``check_program``
flag is on, so a malformed program fails with "op 3 in block 0 reads
'x' before any write" before any kernel launches, instead of a KeyError
in the middle of a run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from paddle_tpu_torch import errors
from paddle_tpu_torch.framework import Program


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _RANK = {ERROR: 0, WARNING: 1, INFO: 2}

    @classmethod
    def includes(cls, level: str, severity: str) -> bool:
        """True when ``severity`` is at or above the requested level
        (level 'warning' includes errors and warnings, not info)."""
        if level == "all":
            level = cls.INFO
        return cls._RANK[severity] <= cls._RANK[level]


@dataclasses.dataclass
class Diagnostic:
    """One structured finding: stable check id, location, fix hint."""

    code: str                       # stable check id, e.g. "PVE01"
    severity: str                   # Severity.ERROR / WARNING / INFO
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None    # index within the block, if op-anchored
    op_type: Optional[str] = None
    var: Optional[str] = None       # variable the finding is about
    hint: Optional[str] = None      # actionable fix suggestion
    pass_name: str = ""

    def format(self) -> str:
        loc = f"block {self.block_idx}"
        if self.op_idx is not None:
            loc += f" op {self.op_idx}"
        if self.op_type:
            loc += f" ({self.op_type})"
        line = f"{self.severity} {self.code} [{loc}]: {self.message}"
        if self.hint:
            line += f" (hint: {self.hint})"
        return line

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ProgramVerificationError(errors.PaddleError):
    """Raised by ``check_or_raise`` when error-tier diagnostics fire."""

    def __init__(self, diagnostics: Sequence[Diagnostic],
                 header: str = "program verification failed"):
        self.diagnostics = list(diagnostics)
        lines = [header] + ["  " + d.format() for d in self.diagnostics]
        super().__init__("\n".join(lines))


class PassContext:
    """State shared across passes for one verification run.

    ``feeds`` / ``fetches`` are None when unknown (lint mode): passes
    then treat declared producer-less vars as the feedable input surface
    and skip fetch-dependent checks.
    """

    def __init__(self, program: Program,
                 feeds: Optional[Set[str]] = None,
                 fetches: Optional[Sequence[str]] = None):
        self.program = program
        self.feeds = set(feeds) if feeds is not None else None
        self.fetches = list(fetches) if fetches is not None else None
        self.diagnostics: List[Diagnostic] = []
        self._implicit_feeds: Optional[Set[str]] = None
        self._writes: Optional[Set[str]] = None

    @property
    def implicit_feeds(self) -> Set[str]:
        if self._implicit_feeds is None:
            from paddle_tpu_torch.analysis import dataflow

            self._implicit_feeds = dataflow.implicit_feed_vars(self.program)
        return self._implicit_feeds

    @property
    def all_writes(self) -> Set[str]:
        if self._writes is None:
            from paddle_tpu_torch.analysis import dataflow

            self._writes = dataflow.program_writes(self.program)
        return self._writes

    def feed_surface(self) -> Set[str]:
        """The names a run may supply from outside: the explicit feed
        set when known, else every declared producer-less var.  Feeding
        a sequence input also supplies its ``<name>@len`` length vector
        (v2/data_feeder.py convention), so declared @len companions of
        fed names count as fed."""
        if self.feeds is None:
            return self.implicit_feeds
        surface = set(self.feeds)
        for name in self.feeds:
            companion = name + "@len"
            if companion in self.implicit_feeds:
                surface.add(companion)
        return surface

    def emit(self, code: str, severity: str, message: str, *,
             block_idx: int = 0, op_idx: Optional[int] = None,
             op_type: Optional[str] = None, var: Optional[str] = None,
             hint: Optional[str] = None, pass_name: str = "") -> Diagnostic:
        d = Diagnostic(code=code, severity=severity, message=message,
                       block_idx=block_idx, op_idx=op_idx, op_type=op_type,
                       var=var, hint=hint, pass_name=pass_name)
        self.diagnostics.append(d)
        return d


@dataclasses.dataclass
class PassInfo:
    name: str
    tier: str                        # most severe diagnostic it can emit
    fn: Callable[[PassContext], None]
    doc: str = ""


class PassManager:
    """Ordered pass pipeline filtered by severity tier."""

    def __init__(self, passes: Optional[Sequence[PassInfo]] = None):
        self.passes: List[PassInfo] = list(passes or [])

    def register(self, info: PassInfo):
        if any(p.name == info.name for p in self.passes):
            raise ValueError(f"analysis pass {info.name!r} already registered")
        self.passes.append(info)

    def run(self, program: Program, feeds: Optional[Set[str]] = None,
            fetches: Optional[Sequence[str]] = None,
            level: str = Severity.WARNING,
            only: Optional[Sequence[str]] = None) -> List[Diagnostic]:
        ctx = PassContext(program, feeds=feeds, fetches=fetches)
        for info in self.passes:
            if only is not None and info.name not in only:
                continue
            if only is None and not Severity.includes(level, info.tier):
                continue
            before = len(ctx.diagnostics)
            info.fn(ctx)
            for d in ctx.diagnostics[before:]:
                if not d.pass_name:
                    d.pass_name = info.name
        if only is not None:
            return ctx.diagnostics
        return [d for d in ctx.diagnostics
                if Severity.includes(level, d.severity)]


_default_manager = PassManager()


def register_pass(name: str, tier: str = Severity.ERROR):
    """Decorator registering an analysis pass on the default manager."""

    def deco(fn):
        _default_manager.register(
            PassInfo(name=name, tier=tier, fn=fn, doc=fn.__doc__ or ""))
        return fn

    return deco


def default_pass_manager() -> PassManager:
    from paddle_tpu_torch.analysis import passes  # noqa: F401  (registers passes)

    return _default_manager


def verify_program(program: Program,
                   feed_names: Optional[Set[str]] = None,
                   fetch_names: Optional[Sequence[str]] = None,
                   level: str = Severity.WARNING,
                   only: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """Run the static checks; returns diagnostics at/above ``level``.

    ``feed_names=None`` means "unknown" — declared producer-less vars
    count as feedable; pass the actual feed set for strict checking.
    """
    return default_pass_manager().run(
        program, feeds=feed_names, fetches=fetch_names, level=level,
        only=only)


def check_or_raise(program: Program,
                   feed_names: Optional[Set[str]] = None,
                   fetch_names: Optional[Sequence[str]] = None,
                   header: str = "program verification failed"):
    """Error-tier gate: raise ProgramVerificationError on any error."""
    diags = verify_program(program, feed_names=feed_names,
                           fetch_names=fetch_names, level=Severity.ERROR)
    errs = [d for d in diags if d.severity == Severity.ERROR]
    if errs:
        raise ProgramVerificationError(errs, header=header)


def format_report(diagnostics: Sequence[Diagnostic]) -> str:
    """Human-readable multi-line report, most severe first."""
    order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
    by_sev = sorted(diagnostics, key=lambda d: (order[d.severity], d.code))
    counts: Dict[str, int] = {}
    for d in diagnostics:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    lines = [d.format() for d in by_sev]
    summary = ", ".join(f"{counts.get(s, 0)} {s}(s)"
                        for s in (Severity.ERROR, Severity.WARNING,
                                  Severity.INFO) if counts.get(s))
    lines.append(summary or "clean: no diagnostics")
    return "\n".join(lines)
