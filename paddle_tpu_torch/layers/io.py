"""Data layer (``paddle_tpu/layers/io.py``)."""

from __future__ import annotations

from paddle_tpu_torch import framework


def data(
    name: str,
    shape,
    dtype="float32",
    lod_level: int = 0,
    append_batch_size: bool = True,
    main_program=None,
    stop_gradient: bool = True,
):
    """Declare an input variable.  ``append_batch_size`` prepends -1 as
    the (dynamic) batch dim."""
    prog = main_program or framework.default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = prog.current_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=stop_gradient,
    )
