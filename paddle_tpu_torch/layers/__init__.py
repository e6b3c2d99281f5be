"""Layers API: build Programs with the same ops, names and attrs as
``paddle_tpu.layers``."""

from paddle_tpu_torch.layers import control_flow, detection, ops
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers.detection import *  # noqa: F401,F403
from paddle_tpu_torch.layers.io import data
from paddle_tpu_torch.layers.nn import (accuracy, batch_norm,
                                        beam_search_decode, chunk_eval,
                                        conv2d, conv2d_transpose, cos_sim,
                                        crf_decoding, cross_entropy, dropout,
                                        dynamic_lstm, embedding,
                                        factorization_machine, fc, gru_unit,
                                        hsigmoid, layer_norm,
                                        linear_chain_crf, log_loss, lrn,
                                        lstm, lstm_unit, matmul, mul,
                                        multi_head_attention, pool2d,
                                        scaled_dot_product_attention,
                                        sigmoid_cross_entropy_with_logits,
                                        softmax_with_cross_entropy,
                                        square_error_cost, topk, warpctc)
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.sequence import (sequence_conv,
                                              sequence_expand,
                                              sequence_first_step,
                                              sequence_last_step,
                                              sequence_pool, sequence_softmax)
from paddle_tpu_torch.layers.tensor import (
    assign, cast, concat, create_global_var, create_tensor, elementwise_add,
    elementwise_div, elementwise_mul, elementwise_sub, fill_constant,
    fill_constant_batch_size_like, gaussian_random, mean, ones, reduce_max,
    reduce_mean, reduce_min, reduce_sum, reshape, scale, split, sums,
    transpose, uniform_random, zeros)

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm", "cross_entropy",
           "topk", "accuracy", "mean", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "embedding", "layer_norm",
           "scaled_dot_product_attention", "multi_head_attention",
           "softmax_with_cross_entropy", "reshape", "transpose", "lstm",
           "dynamic_lstm", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "reduce_sum", "reduce_mean", "reduce_max",
           "reduce_min", "dropout", "lrn", "concat", "mul",
           "square_error_cost", "sigmoid_cross_entropy_with_logits",
           "log_loss", "create_tensor", "create_global_var", "cast", "split",
           "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "scale",
           "gaussian_random", "uniform_random", "gru_unit",
           "linear_chain_crf", "lstm_unit", "matmul", "beam_search_decode",
           "sequence_softmax", "sequence_expand", "sequence_conv",
           "crf_decoding", "chunk_eval", "cos_sim", "warpctc", "hsigmoid",
           "factorization_machine", "conv2d_transpose"] \
    + control_flow.__all__ + ops.__all__ + detection.__all__
