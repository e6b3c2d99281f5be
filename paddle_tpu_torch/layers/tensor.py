"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_tensor``,
``create_global_var``, ``cast``, ``concat``, ``split``, ``sums``,
``assign``, ``fill_constant``, ``fill_constant_batch_size_like``,
``ones``, ``zeros`` (:37-142), ``reshape``, ``transpose``, ``mean``,
``scale``, the elementwise layers with an optional activation
(:148-195), ``reduce_sum/mean/max/min`` (:198-223), ``gaussian_random``
and ``uniform_random`` (:226-250)."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper


def reshape(x, shape, **kwargs):
    helper = LayerHelper("reshape", **kwargs)
    out = helper.create_tmp_variable(x.dtype, tuple(shape))
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm, **kwargs):
    helper = LayerHelper("transpose", **kwargs)
    shape = tuple(x.shape[i] for i in perm) if x.shape else None
    out = helper.create_tmp_variable(x.dtype, shape)
    helper.append_op(type="transpose", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(perm)})
    return out


def create_tensor(dtype, name=None, **kwargs):
    helper = LayerHelper("create_tensor", name=name, **kwargs)
    return helper.block.create_var(name=helper.name, dtype=dtype)


def create_global_var(shape, value, dtype, persistable=False, name=None,
                      **kwargs):
    """A var filled with ``value`` by the startup program, declared in the
    main program too."""
    helper = LayerHelper("global_var", name=name, **kwargs)
    var = helper.startup_program.global_block().create_var(
        name=helper.name, shape=shape, dtype=dtype, persistable=persistable)
    helper.startup_program.global_block().append_op(
        type="fill_constant", outputs={"Out": [var]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    helper.main_program.global_block().create_var(
        name=helper.name, shape=shape, dtype=dtype, persistable=persistable)
    return helper.main_program.global_block().var(helper.name)


def cast(x, dtype, **kwargs):
    helper = LayerHelper("cast", **kwargs)
    out = helper.create_tmp_variable(dtype, x.shape, x.lod_level)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0, **kwargs):
    helper = LayerHelper("concat", **kwargs)
    xs = list(input)
    shape = list(xs[0].shape) if xs[0].shape else None
    if shape is not None:
        shape[axis] = sum(v.shape[axis] for v in xs) if all(
            v.shape and v.shape[axis] is not None and v.shape[axis] >= 0
            for v in xs) else -1
    out = helper.create_tmp_variable(
        xs[0].dtype, tuple(shape) if shape else None, xs[0].lod_level)
    helper.append_op(type="concat", inputs={"X": xs}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def split(input, num_or_sections, dim=0, **kwargs):
    """``num`` equal parts, or parts of the given sizes, along ``dim``."""
    helper = LayerHelper("split", **kwargs)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, None
        sizes = [input.shape[dim] // num] * num if input.shape else None
    else:
        sections = list(num_or_sections)
        num, sizes = 0, sections
    outs = []
    for size in sizes:
        shape = list(input.shape)
        shape[dim] = size
        outs.append(helper.create_tmp_variable(input.dtype, tuple(shape)))
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def sums(input, **kwargs):
    helper = LayerHelper("sums", **kwargs)
    out = helper.create_tmp_variable(input[0].dtype, input[0].shape)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None, **kwargs):
    helper = LayerHelper("assign", **kwargs)
    if output is None:
        output = helper.create_tmp_variable(input.dtype, input.shape,
                                            input.lod_level)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def fill_constant(shape, dtype, value, out=None, **kwargs):
    helper = LayerHelper("fill_constant", **kwargs)
    if out is None:
        out = helper.create_tmp_variable(dtype, tuple(shape))
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  **kwargs):
    helper = LayerHelper("fill_constant_batch_size_like", **kwargs)
    out = helper.create_tmp_variable(dtype, tuple(shape))
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype="float32", **kwargs):
    return fill_constant(shape, dtype, 1.0, **kwargs)


def zeros(shape, dtype="float32", **kwargs):
    return fill_constant(shape, dtype, 0.0, **kwargs)


def mean(x, **kwargs):
    helper = LayerHelper("mean", **kwargs)
    out = helper.create_tmp_variable(x.dtype, ())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, **kwargs):
    helper = LayerHelper("scale", **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias})
    return out


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, **kwargs):
        helper = LayerHelper(op_type, act=act, **kwargs)
        out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")


def _reduce(op_type):
    def layer(input, dim=0, keep_dim=False, reduce_all=False, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        shape = None
        if input.shape is not None:
            if reduce_all:
                shape = (1,) * len(input.shape) if keep_dim else ()
            elif keep_dim:
                shape = tuple(1 if i == dim else s
                              for i, s in enumerate(input.shape))
            else:
                shape = tuple(s for i, s in enumerate(input.shape)
                              if i != dim)
        out = helper.create_tmp_variable(input.dtype, shape)
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"dim": dim, "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")


def gaussian_random(shape, mean=0.0, std=1.0, dtype="float32", seed=0,
                    **kwargs):
    """An in-graph N(mean, std) sample; seed 0 draws from the run's
    generator."""
    helper = LayerHelper("gaussian_random", **kwargs)
    out = helper.create_tmp_variable(dtype, tuple(shape))
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "dtype": dtype,
                            "seed": int(seed)})
    return out


def uniform_random(shape, min=-1.0, max=1.0, dtype="float32", seed=0,
                   **kwargs):
    """An in-graph U(min, max) sample; seed 0 draws from the run's
    generator."""
    helper = LayerHelper("uniform_random", **kwargs)
    out = helper.create_tmp_variable(dtype, tuple(shape))
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "dtype": dtype,
                            "seed": int(seed)})
    return out
