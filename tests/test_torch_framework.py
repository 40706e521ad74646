"""The port's Program IR and DSL build what the JAX package builds."""
import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert

FEEDS = (("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
         ("input_mask", "float32"))


def build_encoder(mod, bert_mod, dtype="float32", seq=128):
    """The tiny BERT encoder (2 layers, hidden 64, 2 heads, vocab 100) built
    with ``mod``'s DSL: (main, startup, feed names, encoder output var)."""
    cfg = bert_mod.BertConfig(vocab_size=100, hidden=64, n_layers=2, n_heads=2,
                              max_seq_len=seq, dtype=dtype)
    main, startup = mod.Program(), mod.Program()
    main.random_seed = 0
    startup.random_seed = 0
    with mod.unique_name.guard(), mod.program_guard(main, startup):
        feeds = [mod.layers.data(n, [seq], dt) for n, dt in FEEDS]
        enc = bert_mod.encoder(*feeds, cfg)
    return main, startup, [f.name for f in feeds], enc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dsl_builds_the_same_encoder_program(dtype):
    jm, js, _, je = build_encoder(fluid, jbert, dtype)
    tm, ts, _, te = build_encoder(pt, tbert, dtype)
    jd, td = jm.to_dict(), tm.to_dict()
    assert [o["type"] for o in jd["blocks"][0]["ops"]] == \
        [o["type"] for o in td["blocks"][0]["ops"]]
    # var names, shapes (-1 batch kept), dtypes, flags; op slots and attrs
    assert jd["blocks"][0]["vars"] == td["blocks"][0]["vars"]
    assert jd["blocks"][0]["ops"] == td["blocks"][0]["ops"]
    assert js.to_dict() == ts.to_dict()
    assert je.name == te.name and je.shape == te.shape == (-1, 128, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_dict_reads_the_jax_program(dtype):
    jm, _, feeds, je = build_encoder(fluid, jbert, dtype)
    pruned = jm._prune(feeds, [je.name], for_test=True)
    text = json.dumps(pruned.to_dict())
    tp = pt.Program.from_json(text)
    assert tp.to_dict() == json.loads(text)
    # the port's own prune of the port's program gives the same inference program
    tm, _, _, te = build_encoder(pt, tbert, dtype)
    assert tm._prune(feeds, [te.name], for_test=True).to_dict() == pruned.to_dict()
    attn = [op for op in tp.global_block().ops if op.type == "fused_attention"]
    assert len(attn) == 2 and all(op.attr("is_test") for op in attn)
    assert all(op.attr("is_test") for op in tp.global_block().ops if op.type == "dropout")


def test_meta_shape_inference_keeps_dynamic_dims():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [7, 48], "float32")                    # [-1, 7, 48]
        y = pt.layers.fc(x, 16, num_flatten_dims=2)             # [-1, 7, 16]
        z = pt.layers.reshape(y, [0, -1, 4, 4])                 # [-1, 7, 4, 4]
        t = pt.layers.transpose(z, [0, 2, 1, 3])                # [-1, 4, 7, 4]
        a, b = pt.layers.split(t, 2, dim=3)
        u = pt.layers.unsqueeze(a, [1])
        c = pt.layers.cast(u, "bfloat16")
        w = pt.data("w", [5], "int64")
        e = pt.layers.embedding(w, [10, 8])
        # a real dim equal to the sentinel's multiple stays static
        big = pt.layers.fc(pt.data("big", [3], "float32"), 7919)
    assert y.shape == (-1, 7, 16)
    assert z.shape == (-1, 7, 4, 4)
    assert t.shape == (-1, 4, 7, 4)
    assert a.shape == b.shape == (-1, 4, 7, 2)
    assert u.shape == (-1, 1, 4, 7, 2) and c.dtype == "bfloat16"
    assert e.shape == (-1, 5, 8) and e.dtype == "float32"
    assert big.shape == (-1, 7919)
    # the startup program's parameter shapes are static
    for op in startup.global_block().ops:
        assert -1 not in op.attr("shape")


def test_shape_inference_touches_no_data():
    """Lowerings run on meta tensors at build time: nothing is drawn or
    allocated, and the attention op's meta path is its plain version."""
    import torch
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q = pt.data("q", [2, 128, 32], "bfloat16")
        out = pt.layers.fused_attention(q, q, q, dropout_prob=0.1, causal=True)
        d = pt.layers.dropout(out, 0.5)
    assert out.shape == (-1, 2, 128, 32) and out.dtype == "bfloat16"
    assert d.shape == out.shape
    g = startup.global_block()
    assert not g.ops
    # the random init ops lower on meta too
    from paddle_tpu_torch.core.registry import LowerCtx, get
    ctx = LowerCtx({"shape": [3, 4], "dtype": "float32", "std": 0.02},
                   device=torch.device("meta"), abstract=True)
    o = get("gaussian_random").lower(ctx, {})["Out"][0]
    assert o.device.type == "meta" and tuple(o.shape) == (3, 4)


def test_clone_for_test_and_program_guard():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        pt.layers.dropout(x, 0.3)
    assert pt.default_main_program() is not main
    test = main.clone(for_test=True)
    assert test.global_block().ops[0].attr("is_test") is True
    assert main.global_block().ops[0].attr("is_test") is False
    assert np.isclose(test.global_block().ops[0].attr("dropout_prob"), 0.3)
