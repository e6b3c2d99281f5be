"""Versioned AOT serving artifacts: a manifest, the run plans' records and
the kernel libraries (``paddle_tpu/aot/artifact.py``).

An artifact directory is one ``paddle compile`` run::

    <dir>/MANIFEST.json           schema, pins, entries, libraries
    <dir>/plans/<id>.json         one run plan's record a entry
    <dir>/kernels/lib<name>-<hash>.so
                                  the kernel libraries the export loaded

A CUDA graph cannot be serialized and a plan of ctypes launches is no
``torch.export`` graph, so an entry is a run plan's static record: the
state it reads, the persistables it writes, the donated, held and fetched
names, and whether it can be captured (its eager reasons).  An entry is
keyed like the Executor's plan cache: (program fingerprint, feed
signature, fetch names).  Loading one skips the verifier and the plan's
classification; the graph is still captured on the plan's second run in a
scope.  The libraries skip ``nvcc``: each file name carries the hash of
the sources and flags it was built from (``kernels/_build.py``
``library_path``), and the loader takes a library only under the name the
running tree's sources give.

The manifest pins what could make a record or a library wrong:

- the environment: torch and its CUDA version, the platform, the card's
  name and compute capability (``nvcc``'s version is recorded, not
  checked: a built library does not need it);
- the tuning database's digest (``kernels/tuning``): a re-tuned config
  changes the launches, so the artifact is exported again;
- the flags that key the plan cache or change how a plan runs: AMP,
  ``trace_ops``, ``graphs_enabled()``;
- per entry, the donation mask proved at export, proved again at load
  and refused on drift.

Every plan lookup counts in ``aot_load_total{result}``: ``loaded`` or a
``rejected_<reason>``; every library lookup counts ``kernel_loaded`` or a
rejection (``rejected_kernels``: a library built from other sources, or
not in the artifact).  A rejection falls back loudly to the plan built as
without an artifact (and ``nvcc`` for a library): slower, never wrong.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from typing import Any, Dict, Optional, Tuple

from paddle_tpu_torch.observability import metrics as _metrics

SCHEMA = "paddle_tpu_torch.aot.v1"
MANIFEST_NAME = "MANIFEST.json"
PLAN_DIR = "plans"
KERNEL_DIR = "kernels"

_M_AOT_LOAD = _metrics.counter(
    "aot_load_total",
    "artifact-store lookups by outcome: loaded, kernel_loaded, or "
    "rejected_* (version / device / tuning_db / flags / fingerprint / "
    "bucket / corrupt / donation_drift / kernels); every rejection falls "
    "back loudly to a plan built in process (or nvcc for a library)")
_M_AOT_EXPORT = _metrics.counter(
    "aot_export_total",
    "run-plan records written into an artifact directory by paddle compile")


def sig_json(feed_sig) -> str:
    """Canonical JSON for an Executor ``_feed_signature`` tuple (the
    manifest's key component)."""
    return json.dumps(feed_sig, separators=(",", ":"), sort_keys=False)


def _device_of(place):
    import torch

    if place is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")
    return place.device()


def nvcc_version() -> str:
    """The last line of ``nvcc --version``, or "none" where no nvcc is
    found (read once)."""
    global _NVCC
    if _NVCC is None:
        import subprocess

        try:
            from paddle_tpu_torch.kernels import _build

            out = subprocess.run([_build.nvcc_path(), "--version"],
                                 capture_output=True, text=True, timeout=60)
            _NVCC = out.stdout.strip().splitlines()[-1]
        except Exception:
            _NVCC = "none"
    return _NVCC


_NVCC: Optional[str] = None


def environment_fingerprint(place=None) -> Dict[str, str]:
    """The environment pins for ``place`` (CUDA card 0, or the CPU
    without a card, when None)."""
    import torch

    device = _device_of(place)
    env = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
           "platform": device.type, "device_kind": "cpu", "capability": ""}
    if device.type == "cuda":
        index = device.index or 0
        env["device_kind"] = torch.cuda.get_device_name(index)
        env["capability"] = "%d.%d" % torch.cuda.get_device_capability(index)
    return env


def tuning_db_digest() -> str:
    """The content hash of the active tuning database ("empty" for none:
    the wrappers' own choices)."""
    try:
        from paddle_tpu_torch.kernels.tuning import get_db

        entries = get_db().entries
    except Exception:   # the tuner never sinks AOT
        return "unavailable"
    if not entries:
        return "empty"
    blob = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def flags_fingerprint() -> Dict[str, Any]:
    """The flags a plan depends on beyond its (program, feeds, fetches)
    key: AMP and ``trace_ops`` key the plan cache; ``graphs_enabled()``
    decides whether a plan is captured."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.executor import graphs_enabled
    from paddle_tpu_torch.flags import FLAGS

    return {"amp": bool(amp.is_enabled()),
            "trace_ops": bool(FLAGS.get("trace_ops")),
            "graphs": bool(graphs_enabled())}


def _entry_id(program_fp: str, sig: str, fetch_names) -> str:
    h = hashlib.sha256()
    h.update(program_fp.encode())
    h.update(b"\x00")
    h.update(sig.encode())
    h.update(b"\x00")
    h.update(json.dumps(list(fetch_names)).encode())
    return h.hexdigest()[:24]


def _sha256_file(path: str) -> Tuple[str, int]:
    with open(path, "rb") as f:
        blob = f.read()
    return hashlib.sha256(blob).hexdigest(), len(blob)


class ArtifactWriter:
    """Collects plan records and the loaded kernel libraries; one ``paddle
    compile`` run writes one and calls ``finish()``."""

    def __init__(self, out_dir: str, place=None):
        self.out_dir = out_dir
        self.place = place
        self.entries: Dict[str, dict] = {}
        self.kernels: Dict[str, dict] = {}
        os.makedirs(os.path.join(out_dir, PLAN_DIR), exist_ok=True)

    def add(self, *, program_fp: str, feed_sig, fetch_names, state_names,
            donated_names, held_names, out_state_names, written_names,
            uses_rng: bool, eager_reasons=()) -> dict:
        """Write one plan's record under its cache key (once a key: the
        warm-up may run a bucket twice)."""
        sig = sig_json(feed_sig)
        eid = _entry_id(program_fp, sig, fetch_names)
        if eid in self.entries:
            return self.entries[eid]
        names = {
            "fetch_names": list(fetch_names),
            "state_names": list(state_names),
            "donated_names": list(donated_names),
            "held_names": list(held_names),
            "out_state_names": list(out_state_names),
            "written_names": list(written_names),
            "uses_rng": bool(uses_rng),
        }
        record = {"program_fp": program_fp, "feed_sig": sig, **names,
                  "eager_reasons": [list(r) for r in eager_reasons]}
        blob = json.dumps(record, sort_keys=True, indent=1).encode()
        rel = os.path.join(PLAN_DIR, f"{eid}.json")
        with open(os.path.join(self.out_dir, rel), "wb") as f:
            f.write(blob)
        entry = {"id": eid, "program_fp": program_fp, "feed_sig": sig,
                 **names, "captures": not eager_reasons, "file": rel,
                 "sha256": hashlib.sha256(blob).hexdigest(),
                 "nbytes": len(blob)}
        self.entries[eid] = entry
        _M_AOT_EXPORT.inc()
        return entry

    def add_kernels(self) -> Dict[str, dict]:
        """Copy every kernel library this process loaded (``_build``) into
        ``kernels/`` under its hashed file name."""
        from paddle_tpu_torch.kernels import _build

        os.makedirs(os.path.join(self.out_dir, KERNEL_DIR), exist_ok=True)
        for name, path in sorted(_build.loaded_from().items()):
            rel = os.path.join(KERNEL_DIR, os.path.basename(path))
            dst = os.path.join(self.out_dir, rel)
            if os.path.abspath(path) != os.path.abspath(dst):
                shutil.copyfile(path, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
            sha, nbytes = _sha256_file(dst)
            self.kernels[name] = {"file": rel, "sha256": sha,
                                  "nbytes": nbytes}
        return self.kernels

    def finish(self, extra: Optional[dict] = None) -> str:
        """Copy the loaded libraries, write MANIFEST.json; returns its
        path."""
        from paddle_tpu_torch.kernels import _build

        self.add_kernels()
        doc = {
            "schema": SCHEMA,
            "env": {**environment_fingerprint(self.place),
                    "nvcc": nvcc_version() if self.kernels else "none",
                    "nvcc_flags": " ".join(_build.NVCC_FLAGS)},
            "tuning_db": tuning_db_digest(),
            "flags": flags_fingerprint(),
            "entries": sorted(self.entries.values(), key=lambda e: e["id"]),
            "kernels": dict(sorted(self.kernels.items())),
        }
        if extra:
            doc.update(extra)
        path = os.path.join(self.out_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


class ArtifactStore:
    """The read side of an artifact directory.

    The store's pins (schema, versions, device, tuning DB, flags) are
    checked once, at open, against ``place`` (CUDA card 0, or the CPU
    without a card, when None); a mismatch poisons the store, and every
    lookup then counts its ``rejected_<reason>`` and falls back.  The
    flags, which may turn after the store opens, are checked again at
    every plan lookup.  An
    entry's own faults (an unknown fingerprint, a missing bucket, a
    corrupt record, donation drift) reject per lookup.  ``results`` holds
    this store's own counts of ``aot_load_total``."""

    def __init__(self, root: str, place=None):
        self.root = root
        self.place = place
        self.poisoned: Optional[str] = None
        self.entries: Dict[Tuple[str, str, Tuple[str, ...]], dict] = {}
        self.fingerprints: set = set()
        self.results: Dict[str, int] = {}
        self.manifest: Optional[dict] = None
        self._warned: set = set()
        try:
            with open(os.path.join(root, MANIFEST_NAME)) as f:
                self.manifest = json.load(f)
            if not isinstance(self.manifest, dict):
                raise ValueError("the manifest is not a JSON object")
        except Exception as exc:
            self.manifest = None
            self.poisoned = "corrupt"
            self._warn(f"unreadable manifest ({exc})")
            return
        self.poisoned = self._validate(self.manifest)
        if self.poisoned is not None:
            return
        try:
            for e in self.manifest.get("entries", ()):
                key = (e["program_fp"], e["feed_sig"],
                       tuple(e["fetch_names"]))
                self.entries[key] = e
                self.fingerprints.add(e["program_fp"])
        except (KeyError, TypeError) as exc:
            self.entries.clear()
            self.poisoned = "corrupt"
            self._warn(f"malformed manifest entry ({exc!r})")

    # -- validation ---------------------------------------------------------

    def _validate(self, doc: dict) -> Optional[str]:
        if doc.get("schema") != SCHEMA:
            self._warn(f"schema {doc.get('schema')!r} != {SCHEMA!r}")
            return "schema"
        env, here = doc.get("env", {}), environment_fingerprint(self.place)
        for k in ("torch", "cuda"):
            if env.get(k) != here[k]:
                self._warn(f"{k} {env.get(k)!r} != running {here[k]!r}")
                return "version"
        for k in ("platform", "device_kind", "capability"):
            if env.get(k) != here[k]:
                self._warn(f"{k} {env.get(k)!r} != running {here[k]!r}")
                return "device"
        if doc.get("tuning_db") != tuning_db_digest():
            self._warn("tuning DB drifted since export (re-run "
                       "`paddle compile` after `paddle tune`)")
            return "tuning_db"
        if doc.get("flags") != flags_fingerprint():
            self._warn(f"flags {doc.get('flags')!r} != running "
                       f"{flags_fingerprint()!r}")
            return "flags"
        return None

    def _warn(self, msg: str) -> None:
        if msg in self._warned:
            return
        self._warned.add(msg)
        print(f"[paddle_tpu_torch.aot] artifact store {self.root}: {msg} "
              "-- falling back to plans built in process", file=sys.stderr)

    def _count(self, result: str) -> None:
        self.results[result] = self.results.get(result, 0) + 1
        _M_AOT_LOAD.inc(result=result)

    # -- lookup -------------------------------------------------------------

    def lookup(self, program_fp: str, sig: str, fetch_names,
               validate=None):
        """``(meta, record)`` for a manifest match, or None after counting
        the rejection.  ``validate`` (meta -> reason or None) runs before
        the record is read: the executor proves the donation mask again
        there."""
        if self.poisoned is not None:
            self._count(f"rejected_{self.poisoned}")
            return None
        flags = flags_fingerprint()
        if self.manifest.get("flags") != flags:
            # a flag turned since the store opened: the plan cache keys on
            # AMP and trace_ops, and a record's eager reasons are the
            # export's (trace_ops keeps a plan eager)
            self._warn(f"flags {self.manifest.get('flags')!r} != running "
                       f"{flags!r}")
            self._count("rejected_flags")
            return None
        meta = self.entries.get((program_fp, sig, tuple(fetch_names)))
        if meta is None:
            if program_fp in self.fingerprints:
                # the program is known, this (bucket, fetch) was never
                # exported: a wider serve ladder than the export's
                self._warn(f"no entry for feed signature {sig} (program "
                           f"{program_fp[:12]})")
                self._count("rejected_bucket")
            else:
                self._warn(f"program fingerprint {program_fp[:12]} not in "
                           "the manifest (the model or the optimizer "
                           "changed since export)")
                self._count("rejected_fingerprint")
            return None
        if validate is not None:
            reason = validate(meta)
            if reason is not None:
                self._warn(f"entry {meta['id']}: {reason}")
                self._count(f"rejected_{reason.split(':')[0]}")
                return None
        record = self._read_record(meta)
        if record is None:
            return None
        self._count("loaded")
        return meta, record

    def _read_record(self, meta: dict) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, meta["file"]), "rb") as f:
                blob = f.read()
            if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
                raise ValueError("record sha256 mismatch (truncated or "
                                 "corrupt file)")
            record = json.loads(blob)
            for k in ("fetch_names", "state_names", "donated_names",
                      "held_names", "out_state_names", "written_names",
                      "uses_rng"):
                if record.get(k) != meta[k]:
                    raise ValueError(f"record {k} differs from the "
                                     "manifest's")
            return record
        except Exception as exc:
            self._warn(f"entry {meta['id']}: {type(exc).__name__}: {exc}")
            self._count("rejected_corrupt")
            return None

    def kernel_path(self, name: str, want_file: str) -> Optional[str]:
        """The path of kernel library ``name`` in the artifact where its
        file name is ``want_file`` (the hash of the running tree's sources
        and flags) and its bytes are the manifest's, else None after
        counting the rejection (the library is then built by nvcc)."""
        if self.poisoned is not None:
            self._count(f"rejected_{self.poisoned}")
            return None
        entry = (self.manifest.get("kernels") or {}).get(name)
        if entry is None or os.path.basename(entry["file"]) != want_file:
            have = None if entry is None else os.path.basename(entry["file"])
            self._warn(f"kernel library {name}: the artifact holds {have}, "
                       f"the running sources build {want_file}")
            self._count("rejected_kernels")
            return None
        path = os.path.join(self.root, entry["file"])
        try:
            sha, _ = _sha256_file(path)
        except OSError as exc:
            sha = f"unreadable ({exc})"
        if sha != entry["sha256"]:
            self._warn(f"kernel library {name}: sha256 {sha} is not the "
                       "manifest's (truncated or corrupt file)")
            self._count("rejected_corrupt")
            return None
        self._count("kernel_loaded")
        return path

    # -- introspection ------------------------------------------------------

    def info(self) -> dict:
        return {
            "root": self.root,
            "poisoned": self.poisoned,
            "entries": len(self.entries),
            "results": dict(self.results),
        }
