"""conv+BN fusion program rewrite (the port's copy of
``paddle_tpu/contrib/fuse_conv_bn.py``).

Rewrites [conv2d 1x1/s1 NHWC -> batch_norm -> (relu)] chains of a training
program into the ``conv2d_bn_fused`` op, whose CUDA kernel sums the batch
statistics in the conv's epilogue (``ops/conv_bn.py``). Train-mode batch
norm cannot be folded into the conv weights (its statistics depend on the
batch), so the pass fuses the statistics instead.

Opt-in: only batch_norm ops built with fuse_stats=True are considered.
"""
from __future__ import annotations

from ..framework import Program


def _is_1x1_s1_conv(op, block):
    if op.type != "conv2d":
        return False
    w = block.find_var_recursive(op.inputs["Filter"][0])
    if w is None or tuple(w.shape[2:]) != (1, 1):
        return False
    if (op.attr("data_format", "NCHW") or "NCHW") != "NHWC":
        return False
    strides = op.attr("strides", [1, 1]) or [1, 1]
    pads = op.attr("paddings", [0, 0]) or [0, 0]
    dil = op.attr("dilations", [1, 1]) or [1, 1]
    groups = op.attr("groups", 1) or 1
    return (all(int(s) == 1 for s in strides) and
            all(int(p) == 0 for p in pads) and
            all(int(d) == 1 for d in dil) and int(groups) == 1)


def fuse_conv_bn_stats(program: Program) -> int:
    """Rewrite eligible [conv2d -> batch_norm(fuse_stats=True) -> (relu)]
    chains into conv2d_bn_fused ops, in place. Returns the number of chains
    fused. Eligibility: 1x1/s1/p0/g1 NHWC conv whose output feeds ONLY the
    batch_norm; train-mode BN; optional relu absorbed when it is the sole
    consumer of the BN output.

    Run this on the FORWARD program, before optimizer.minimize(): backward
    ops consume the conv output too, and the fused op gets its gradient
    from the registry's generic grad over the fused lowering.
    """
    block = program.global_block()
    ops = list(block.ops)
    consumers = {}
    for o in ops:
        for ns in o.inputs.values():
            for n in ns:
                consumers.setdefault(n, []).append(o)

    fused = 0
    new_ops = []
    skip = set()
    for idx, op in enumerate(ops):
        if id(op) in skip:
            continue
        if (op.type == "batch_norm" and op.attr("fuse_stats", False)
                and not op.attr("is_test", False)
                and not op.attr("use_global_stats", False)
                and (op.attr("data_layout", "NCHW") == "NHWC")):
            x_name = op.inputs["X"][0]
            prod = next((p for p in new_ops
                         if x_name in [n for ns in p.outputs.values()
                                       for n in ns]), None)
            if (prod is not None and _is_1x1_s1_conv(prod, block)
                    and len(consumers.get(x_name, [])) == 1):
                act = None
                bn_y = op.outputs["Y"][0]
                nxt = consumers.get(bn_y, [])
                if (len(nxt) == 1 and nxt[0].type == "relu"
                        and idx + 1 < len(ops) and ops[idx + 1] is nxt[0]):
                    act = "relu"
                    y_out = nxt[0].outputs["Out"][0]
                    skip.add(id(nxt[0]))
                else:
                    y_out = bn_y
                new_ops.remove(prod)
                attrs = {"epsilon": op.attr("epsilon", 1e-5),
                         "momentum": op.attr("momentum", 0.9),
                         "act": act}
                block.ops = new_ops  # append_op appends here
                block.append_op(
                    "conv2d_bn_fused",
                    inputs={"Input": prod.inputs["Input"],
                            "Filter": prod.inputs["Filter"],
                            "Scale": op.inputs["Scale"],
                            "Bias": op.inputs["Bias"],
                            "Mean": op.inputs["Mean"],
                            "Variance": op.inputs["Variance"]},
                    outputs={"Y": [y_out],
                             "MeanOut": op.outputs["MeanOut"],
                             "VarianceOut": op.outputs["VarianceOut"],
                             "SavedMean": op.outputs["SavedMean"],
                             "SavedVariance": op.outputs["SavedVariance"]},
                    attrs=attrs, infer_shape=False)
                new_ops = list(block.ops)
                fused += 1
                continue
        new_ops.append(op)
    block.ops = new_ops
    return fused
