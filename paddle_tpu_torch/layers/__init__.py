"""fluid.layers-style DSL surface: the layers the port's models build with."""
from .io import (create_py_reader_by_data, data, double_buffer, load,  # noqa: F401
                 py_reader, read_file)
from .nn import (abs, accuracy, acos, adaptive_pool2d, asin, atan, auc, batch_norm,  # noqa: F401
                 beam_append, beam_search, beam_search_decode, brelu, cast, ceil, clip,
                 clip_by_norm, conv2d, conv2d_transpose, cos, cos_sim, cosh, cross_entropy, cross_entropy2,
                 dropout, elementwise_add, elementwise_div, elementwise_floordiv,
                 elementwise_max, elementwise_min, elementwise_mod, elementwise_mul,
                 elementwise_pow, elementwise_sub, elu, embedding, erf, exp, expand, fc,
                 flatten, floor, fused_attention, gather, gather_nd, gaussian_random, gelu,
                 group_norm, instance_norm, prelu,
                 hard_shrink, hard_sigmoid, hard_swish, huber_loss, image_resize, l2_normalize,
                 label_smooth, layer_norm, leaky_relu, log, log_loss, log_softmax,
                 logsigmoid, matmul, mean, mish, mul, one_hot, pad, pad2d, pool2d, pow,
                 reciprocal, reduce_all, reduce_any, reduce_max, reduce_mean, reduce_min,
                 reduce_prod, reduce_sum, relu, relu6, reshape, resize_bilinear, resize_nearest,
                 round, rsqrt, scale, scatter,
                 shape, sigmoid, sigmoid_cross_entropy_with_logits, sign, sin, sinh, slice,
                 smooth_l1, soft_relu, softmax, softmax_with_cross_entropy, softplus,
                 softshrink, softsign, split, sqrt, square, square_error_cost, squeeze, stack,
                 stanh, swish, tanh, tanh_shrink, thresholded_relu, topk, transpose,
                 uniform_random, unsqueeze, unstack, where)
from .tensor import (argmax, argmin, argsort, assign, concat,  # noqa: F401
                     tensor_array_to_tensor,
                     create_global_var, create_parameter, create_tensor, diag, eye,
                     fill_constant, fill_constant_batch_size_like, has_inf, has_nan,
                     isfinite, linspace, ones, ones_like, reverse, sums, zeros, zeros_like)
from .tensor import range as range_  # noqa: F401  (import-* safe alias)
from .tensor import range  # noqa: F401  (the reference exports `range` itself)
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (cosine_decay, exponential_decay,  # noqa: F401
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay, piecewise_decay,
                                      polynomial_decay)
from .control_flow import (DynamicRNN, IfElse, Print, Scan, StaticRNN,  # noqa: F401
                           Switch, While, array_length, array_read, array_write,
                           create_array, equal, greater_equal, greater_than, increment,
                           is_empty, less_equal, less_than, not_equal,
                           reorder_lod_tensor_by_rank)
from .rnn import gru_unit, lstm_unit, simple_gru, simple_lstm  # noqa: F401
from .nn import (LayerHelper, Variable, chunk_eval, convert_dtype,  # noqa: F401
                 default_main_program, deformable_conv, sequence_mask, similarity_focus)
from .extras import (autoincreased_step_counter, crf_decoding,  # noqa: F401
                     dynamic_gru, dynamic_lstm, expand_as, host_embedding,
                     linear_chain_crf,
                     logical_and, logical_not, logical_or, logical_xor, mse_loss, rank,
                     scatter_nd, scatter_nd_add, shard_index, space_to_depth,
                     fsp_matrix, strided_slice, sum,
                     maxout, lrn, pixel_shuffle, shuffle_channel, temporal_shift, unfold,
                     affine_channel, bilinear_tensor_product, add_position_encoding,
                     multiplex, crop, crop_tensor, pad_constant_like, row_conv, tree_conv,
                     uniform_random_batch_size_like, gaussian_random_batch_size_like,
                     selu, mean_iou, rank_loss, margin_rank_loss, bpr_loss, kldiv_loss,
                     dice_loss, npair_loss, sampled_softmax_with_cross_entropy, nce,
                     hsigmoid, warpctc, ctc_greedy_decoder, edit_distance, sampling_id,
                     gather_tree, size, dynamic_lstmp, lstm, im2sequence, hash, lod_reset,
                     lod_append, get_tensor_from_selected_rows, merge_selected_rows,
                     continuous_value_model, py_func, conv3d, conv3d_transpose, pool3d,
                     adaptive_pool3d, resize_trilinear, image_resize_short, spectral_norm,
                     data_norm, center_loss, affine_grid, grid_sampler, random_crop,
                     unique, unique_with_counts, teacher_student_sigmoid_loss)
from .sequence import (sequence_conv, sequence_first_step,  # noqa: F401
                       sequence_last_step, sequence_pool, sequence_reverse,
                       sequence_unpad, sequence_softmax, sequence_concat, sequence_expand,
                       sequence_expand_as, sequence_pad, sequence_slice, sequence_enumerate,
                       sequence_erase, sequence_reshape, sequence_scatter)
from . import distributions  # noqa: F401
from .detection import *  # noqa: F401,F403  (its __all__: the 28 detection layers)
from . import collective  # noqa: F401  (the c_* collective wrappers)
