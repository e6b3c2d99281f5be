"""Hand-written CUDA kernels of the port, one module each, beside the
plain PyTorch version of the same function.

A wrapper launches its kernel on a CUDA tensor, or raises on a tensor
the kernel does not take; it runs the plain version only on a CPU
tensor.  Each wrapper module counts its launches in ``launches`` (the
forward), and ``conv`` and ``batch_norm`` count their gradient kernels
beside it (``bwd_input_launches``, ``dw_launches``, ``bwd_launches``,
``dq_launches``, ``dkv_launches``); a kernel with a bf16 instance
counts its bf16 launches apart, in the counter's ``_bf16`` twin.
A kernel with a backward has a ``torch.autograd.Function`` whose
backward is a kernel too where the TPU kernel had one (the LSTM's
backward is plain PyTorch, as the JAX package's is a ``lax.scan``).
Sources live in ``paddle_tpu_torch/csrc``; ``_build`` compiles them at
first use.

A replay of a captured CUDA graph runs no Python, so no wrapper counts
its launches there: the Executor takes each counter's change over the
capture (``launch_counts``) and adds it again on every replay
(``add_launch_counts``), so N replays read as N eager runs.
"""

import threading
from typing import Dict, Tuple

from paddle_tpu_torch.kernels import (batch_norm, conv, embedding,
                                      flash_attention, lstm, matmul,
                                      paged_attention, softmax)

__all__ = ["add_launch_counts", "batch_norm", "conv", "embedding",
           "flash_attention", "launch_counts", "lstm", "matmul",
           "paged_attention", "softmax"]

_MODULES = (batch_norm, conv, embedding, flash_attention, lstm, matmul,
            paged_attention, softmax)
_add_lock = threading.Lock()


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every launch counter of every wrapper module, by (module, name):
    the module-level ints whose names hold ``launches``."""
    return {(mod.__name__, name): value
            for mod in _MODULES for name, value in vars(mod).items()
            if "launches" in name and isinstance(value, int)
            and not isinstance(value, bool)}


def add_launch_counts(delta: Dict[Tuple[str, str], int]) -> None:
    """Add ``delta`` (from two ``launch_counts``) to the counters, under
    each module's own count lock where it has one."""
    by_name = {mod.__name__: mod for mod in _MODULES}
    with _add_lock:
        for (mod_name, name), d in delta.items():
            if not d:
                continue
            mod = by_name[mod_name]
            lock = getattr(mod, "_count_lock", None)
            if lock is None:
                setattr(mod, name, getattr(mod, name) + d)
            else:
                with lock:
                    setattr(mod, name, getattr(mod, name) + d)
