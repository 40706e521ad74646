"""fluid.layers-style DSL surface: the layers the port's models build with."""
from .io import (create_py_reader_by_data, data, double_buffer, load,  # noqa: F401
                 py_reader, read_file)
from .nn import (accuracy, auc, batch_norm, beam_append, beam_search,  # noqa: F401
                 beam_search_decode, cast, clip, clip_by_norm, conv2d, cos_sim,
                 cross_entropy, dropout, elementwise_add, elementwise_div, elementwise_max,
                 elementwise_mul, elementwise_sub, embedding, expand, fc, fused_attention,
                 gather, gelu, label_smooth, layer_norm, log_softmax, matmul, mean,
                 one_hot, pool2d, reduce_sum, relu, reshape, scale, sigmoid,
                 sigmoid_cross_entropy_with_logits, slice, softmax,
                 softmax_with_cross_entropy, split, sqrt, square, square_error_cost,
                 squeeze, tanh, topk, transpose, unsqueeze)
from .tensor import (assign, concat, create_parameter, fill_constant,  # noqa: F401
                     fill_constant_batch_size_like, sums)
from .control_flow import (Scan, equal, greater_equal, greater_than,  # noqa: F401
                           less_equal, less_than, not_equal)
from .rnn import gru_unit, lstm_unit, simple_gru, simple_lstm  # noqa: F401
from .extras import (crf_decoding, dynamic_gru, dynamic_lstm,  # noqa: F401
                     linear_chain_crf, sum)
from .sequence import (sequence_conv, sequence_first_step,  # noqa: F401
                       sequence_last_step, sequence_pool, sequence_reverse,
                       sequence_unpad)
