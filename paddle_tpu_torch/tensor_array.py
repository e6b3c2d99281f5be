"""TensorArray, the LoDTensorArray of the port (``paddle_tpu/tensor_array.py``).

A dense ``(capacity, ...)`` stack and an int32 scalar length, both
tensors on one device.  ``write`` returns a new array (the stack copied
with one slot replaced), as the JAX package's functional update does, so
a value that still holds the old array keeps its contents.  The slot
index stays a tensor: neither a write nor a read takes it to the host.
An index at or past ``capacity`` (or below 0) is clamped to the last
(first) slot, as ``lax.dynamic_update_slice`` and ``lax.dynamic_slice``
clamp their start.  A slot never written reads as zeros.
"""

from __future__ import annotations

import torch


def _slot(index, capacity: int, device) -> torch.Tensor:
    """The clamped slot of ``index`` as a one-element int64 tensor."""
    idx = torch.as_tensor(index, device=device).reshape(-1)[:1].long()
    return idx.clamp(0, capacity - 1)


class TensorArray:
    def __init__(self, stack: torch.Tensor, length: torch.Tensor):
        self.stack = stack
        self.length = length

    @classmethod
    def create(cls, capacity: int, elem_shape, dtype=torch.float32,
               device=None) -> "TensorArray":
        return cls(torch.zeros((capacity,) + tuple(elem_shape), dtype=dtype,
                               device=device),
                   torch.zeros((), dtype=torch.int32, device=device))

    def write(self, index, value) -> "TensorArray":
        slot = _slot(index, self.capacity, self.stack.device)
        stack = self.stack.index_copy(
            0, slot, value.reshape((1,) + tuple(self.stack.shape[1:]))
            .to(self.stack.dtype))
        written = torch.as_tensor(index, device=self.stack.device).reshape(
            -1)[0].to(torch.int32) + 1
        return TensorArray(stack, torch.maximum(self.length, written))

    def read(self, index) -> torch.Tensor:
        slot = _slot(index, self.capacity, self.stack.device)
        return self.stack.index_select(0, slot)[0]

    @property
    def capacity(self) -> int:
        return self.stack.shape[0]

    def __repr__(self):
        return (f"TensorArray(capacity={self.capacity}, "
                f"elem={tuple(self.stack.shape[1:])})")
