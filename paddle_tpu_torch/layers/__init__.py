"""fluid.layers-style DSL surface: the layers the port's models build with."""
from .io import (create_py_reader_by_data, data, double_buffer, load,  # noqa: F401
                 py_reader, read_file)
from .nn import (accuracy, auc, batch_norm, beam_append, beam_search,  # noqa: F401
                 beam_search_decode, cast, clip, clip_by_norm, conv2d, cross_entropy,
                 dropout, elementwise_add, elementwise_div, elementwise_max,
                 elementwise_mul, elementwise_sub, embedding, expand, fc, fused_attention,
                 gather, gelu, label_smooth, layer_norm, log_softmax, matmul, mean,
                 one_hot, pool2d, reduce_sum, relu, reshape, scale, sigmoid,
                 sigmoid_cross_entropy_with_logits, slice, softmax,
                 softmax_with_cross_entropy, split, sqrt, square, squeeze, topk,
                 transpose, unsqueeze)
from .tensor import assign, concat, create_parameter, fill_constant, sums  # noqa: F401
from .control_flow import (Scan, equal, greater_equal, greater_than,  # noqa: F401
                           less_equal, less_than, not_equal)
