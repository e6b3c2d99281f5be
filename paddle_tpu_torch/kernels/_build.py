"""Build and load the CUDA kernel libraries of ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/paddle_tpu_torch/`` beside
the package; a library's file name carries a hash of its sources and
flags, so an edited source never loads a stale build.  ``build()``
starts one ``nvcc`` per missing library, all at once.

A wrapper may drop its scratch tensors as soon as it has queued a
launch: PyTorch's caching allocator hands that memory only to work
queued later on the same stream, and the kernels run on the caller's
current stream.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "paddle_tpu_torch")

#: The kernel libraries, one per ``csrc/<name>.cu``.
LIBRARIES = ("conv", "conv_dw", "batch_norm", "matmul", "softmax",
             "flash_attention", "lstm", "embedding", "paged_attention")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "CUDA kernels of paddle_tpu_torch build from source at first use")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(name: str, out: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", out,
            source_path(name)]


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, Tuple[float, str]]:
    """Compile every named library that is not built yet, one ``nvcc``
    process each, all started together.  Returns ``{name: (seconds,
    compiler log)}`` for the ones it built; raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source_path(name)} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  Every entry
    in ``signatures`` (C function name -> ctypes argtypes) returns an
    int error code.  Once loaded, a call takes no lock, and ctypes keeps
    each C function it has resolved as an attribute of the library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of CUDA tensor ``t``'s device
    (the stream ``launch`` launches on), without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(fn, t: torch.Tensor, *args) -> int:
    """``fn(*args, stream)``: a C entry called on the current stream of
    CUDA tensor ``t``'s device (the capture stream inside
    ``torch.cuda.graph``, ``s`` inside ``torch.cuda.stream(s)``, each
    thread's own), as its raw handle, without building a
    ``torch.cuda.Stream``; the current device is switched to ``t``'s only
    where it is another.  Returns ``fn``'s error code."""
    index = t.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))


#: The dtypes a kernel takes: float32 only, or float32 and bf16 (a
#: ``_bf16`` instance beside the ``_f32`` one, picked by the dtype).
F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)

#: The suffix of a kernel's C symbol for each dtype it takes.
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: The GEMM engines of the matmul and conv, as their C entries number
#: them (``engine`` argument): the SIMT tile (float32) or the mma.sync
#: tile (bf16), and the wgmma engine (split TF32 in float32).
ENGINES = {"mma.sync": 0, "simt": 0, "wgmma": 1}


def split_scratch(engine: str, *operands: torch.Tensor):
    """The float32 wgmma engine's scratch: a hi and a lo float32 copy of
    each operand, one tensor of twice its size each (None for the other
    engines).  The caller keeps them until its launch is queued."""
    if engine != "wgmma":
        return (None,) * len(operands)
    return tuple(torch.empty(2 * t.numel(), dtype=torch.float32,
                             device=t.device) for t in operands)


def address(t) -> int:
    """A tensor's device address, or 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()


def recording(*tensors) -> bool:
    """Whether autograd records any of ``tensors``: grad mode on and one
    of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_recording(what: str, *tensors) -> None:
    """Raise (RuntimeError) where autograd records a tensor that requires
    grad: a kernel launched through ctypes is opaque to autograd, so its
    result would carry no gradient back to its inputs, silently.  An op
    that autograd replays (a step block's ops under ``recurrent_grad``)
    launches through the kernel's ``torch.autograd.Function``, whose
    forward runs with recording off."""
    if recording(*tensors):
        raise RuntimeError(
            f"{what}: a raw kernel launch on a tensor that requires grad "
            "while autograd records; call the kernel's autograd.Function "
            "instead")


def require_cuda(what: str, dtypes, *tensors) -> None:
    """Raise on what a CUDA kernel does not take: tensors of another
    dtype than one of ``dtypes``, or of two dtypes (TypeError); another
    device, or a non-contiguous tensor (ValueError); a tensor autograd
    records (``refuse_recording``).  A bf16 tensor given to a
    float32-only kernel raises: the wrappers never upcast."""
    for t in tensors:   # the common case first, in a few attribute reads
        if not (t.is_cuda and t.dtype in dtypes and not t.requires_grad
                and t.is_contiguous()):
            break
    else:
        if len(tensors) == 1 or len({t.dtype for t in tensors}) == 1:
            return
    refuse_recording(what, *tensors)
    got = [t.dtype for t in tensors]
    if len(set(got)) != 1 or got[0] not in dtypes:
        raise TypeError(f"{what} kernel takes one dtype of "
                        f"{[str(d) for d in dtypes]}, got {got}")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")


def wgmma_attributes(lib: ctypes.CDLL, fn: str, *args) -> dict:
    """What ``fn`` (a library's ``ptt_*_wgmma_attributes`` entry) reports
    of one wgmma engine instance: registers a thread, spill (local) bytes,
    static and dynamic shared memory a block."""
    out = (ctypes.c_int * 4)()
    check(lib, getattr(lib, fn)(*args, out), fn)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out))


def sass_opcodes(name: str, *parts: str) -> Dict[str, Dict[str, int]]:
    """{mangled function name: {opcode: count}} of the built library
    ``name``'s kernels whose mangled names contain every one of ``parts``,
    from ``cuobjdump -sass`` beside nvcc: static counts, so an unrolled
    loop's instructions count once each."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library_path(name)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        fn = body.split("\n", 1)[0].strip()
        if all(p in fn for p in parts):
            ops = out.setdefault(fn, {})
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_]*)", body):
                ops[op] = ops.get(op, 0) + 1
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` does not report it)."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} (error {err})")
