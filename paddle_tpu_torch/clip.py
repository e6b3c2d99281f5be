"""Gradient clipping (the port of ``paddle_tpu/clip.py``): a clip
appends ops that rewrite each (param, grad) pair before the optimizer's
update ops (``Optimizer.minimize`` calls ``append_clip_ops``)."""

from __future__ import annotations

from paddle_tpu_torch.framework import Block, unique_name


class BaseGradientClip:
    def append_clip_ops(self, block: Block, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max_value, min_value=None):
        self.max_value = float(max_value)
        self.min_value = float(min_value if min_value is not None else -max_value)

    def append_clip_ops(self, block, params_grads):
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name(g.name + "_clip"),
                                  shape=g.shape, dtype=g.dtype,
                                  stop_gradient=True)
            block.append_op(type="clip", inputs={"X": [g]},
                            outputs={"Out": [ng]},
                            attrs={"min": self.min_value, "max": self.max_value})
            out.append((p, ng))
        return out


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def append_clip_ops(self, block, params_grads):
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name(g.name + "_clip"),
                                  shape=g.shape, dtype=g.dtype,
                                  stop_gradient=True)
            block.append_op(type="clip_by_norm", inputs={"X": [g]},
                            outputs={"Out": [ng]},
                            attrs={"max_norm": self.clip_norm})
            out.append((p, ng))
        return out


class GradientClipByGlobalNorm(BaseGradientClip):
    """g_i *= clip_norm / max(global_norm, clip_norm), with
    global_norm = sqrt(sum_i ||g_i||^2)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def append_clip_ops(self, block, params_grads):
        sq_norms = []
        for _, g in params_grads:
            n = block.create_var(name=unique_name(g.name + "_sqn"),
                                 shape=(1,), dtype="float32", stop_gradient=True)
            block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [n]})
            sq_norms.append(n)
        total = block.create_var(name=unique_name("global_sqn"), shape=(1,),
                                 dtype="float32", stop_gradient=True)
        block.append_op(type="sum", inputs={"X": sq_norms},
                        outputs={"Out": [total]})
        gnorm = block.create_var(name=unique_name("global_norm"), shape=(1,),
                                 dtype="float32", stop_gradient=True)
        block.append_op(type="sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        # scale = clip / max(gnorm, clip)
        denom = block.create_var(name=unique_name("clip_denom"), shape=(1,),
                                 dtype="float32", stop_gradient=True)
        cvar = block.create_var(name=unique_name("clip_const"), shape=(1,),
                                dtype="float32", stop_gradient=True)
        block.append_op(type="fill_constant", outputs={"Out": [cvar]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self.clip_norm})
        block.append_op(type="elementwise_max", inputs={"X": [gnorm], "Y": [cvar]},
                        outputs={"Out": [denom]})
        scale = block.create_var(name=unique_name("clip_scale"), shape=(1,),
                                 dtype="float32", stop_gradient=True)
        block.append_op(type="elementwise_div", inputs={"X": [cvar], "Y": [denom]},
                        outputs={"Out": [scale]})
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name(g.name + "_clip"),
                                  shape=g.shape, dtype=g.dtype,
                                  stop_gradient=True)
            block.append_op(type="elementwise_mul",
                            inputs={"X": [g], "Y": [scale]},
                            outputs={"Out": [ng]}, attrs={"axis": 0})
            out.append((p, ng))
        return out


ClipByValue = GradientClipByValue
ClipByNorm = GradientClipByNorm
ClipByGlobalNorm = GradientClipByGlobalNorm
