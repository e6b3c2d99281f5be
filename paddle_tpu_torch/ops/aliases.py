"""cuDNN-named op aliases (``paddle_tpu/ops/aliases.py``): the same
lowering, inputs, gradient inputs and shape rule as their targets, and
the target's own grad rule where it has one (``conv2d``'s: the generic
replay must never reach a kernel launch, ``autodiff.py``).  Imported
last, so that every target exists."""

from __future__ import annotations

from paddle_tpu_torch.registry import OpRegistry, register_op


def _alias_op(alias: str, target: str, inputs, outputs=("Out",)):
    info = OpRegistry.get(target)
    register_op(alias, inputs=inputs, outputs=outputs,
                diff_inputs=info.diff_inputs,
                infer_shape=info.infer_shape,
                grad_lower=info.grad_lower)(info.lower)


_alias_op("conv2d_cudnn", "conv2d", ("Input", "Filter"), ("Output",))
_alias_op("pool2d_cudnn", "pool2d", ("X",))
_alias_op("conv3d_cudnn", "conv3d", ("Input", "Filter"), ("Output",))
_alias_op("conv2d_transpose_cudnn", "conv2d_transpose", ("Input", "Filter"),
          ("Output",))
_alias_op("conv3d_transpose_cudnn", "conv3d_transpose", ("Input", "Filter"),
          ("Output",))
_alias_op("pool3d_cudnn", "pool3d", ("X",))
