"""Where a training step spends its time on the card.

    python3 -m paddle_tpu_torch.tools.train_profile              # BERT-base
    python3 -m paddle_tpu_torch.tools.train_profile resnet50     # ResNet-50
    python3 -m paddle_tpu_torch.tools.train_profile transformer  # Transformer NMT
    python3 -m paddle_tpu_torch.tools.train_profile deepfm       # DeepFM CTR
    python3 -m paddle_tpu_torch.tools.train_profile mnist        # MNIST MLP
    python3 -m paddle_tpu_torch.tools.train_profile pipeline     # BERT-base, 4 microbatches

BERT-base: builds the pretraining program (L12 H768 A12, FFN 3072, vocab
30522, bf16, dropout 0.1, tied MLM decode) at the configuration of
``bench.py::bench_bert_base`` -- batch 128, S 128, 20 masked positions per
sequence, ``Adam(1e-4)``, seed 0 -- with the port's DSL, ``append_backward``
and ``Adam.minimize``; runs its startup program on the card, takes two warm
steps, then traces 3 steps with ``torch.profiler``. Prints one JSON line:
wall time per step, device busy time (the sum of the device activities, one
stream), the idle share, device activities per step, device time by kind
(the attention kernels, matmuls, copies, everything else) and the top
kernels by device time. Needs a CUDA card.

ResNet-50: builds the training program at ``bench.py::bench_resnet50``'s
configuration -- batch 128, 224 x 224, bf16, NHWC, the space-to-depth stem,
1000 classes, ``Momentum(0.1, 0.9)``, seed 0 -- with every batch norm marked
``fuse_stats`` and ``contrib.fuse_conv_bn_stats`` run before ``minimize``,
so its 33 1x1/s1 conv + batch-norm chains run on the CUDA ``conv1x1_bn``
kernel; then profiles it the same way.

    python3 -m paddle_tpu_torch.tools.train_profile transformer

Transformer NMT: transformer-base as ``bench_workloads.py::bench_transformer``
builds it -- vocabularies 32000, hidden 512, 6 + 6 layers, 8 heads, FFN
2048, dropout 0.1, label smoothing 0.1, ``Adam(1e-4)``, f32, batch 64,
source and target length 64, seed 0 -- profiled the same way.

DeepFM CTR: ``models/deepfm.py`` as ``bench_workloads.py::bench_deepfm``
builds it -- batch 4096, 26 sparse fields over a vocabulary of 1,000,000,
embedding 16, 13 dense features, deep tower 400-400-400, the ``auc``
metric with 4095 thresholds, ``Adam(1e-3)``, f32, seed 0 -- profiled the
same way (the row gradients of the two tables are ``index_put_``'s sort and
accumulation kinds).

MNIST MLP: ``models/mnist.py::mlp`` (784 -> 128 -> 64 -> 10) at batch 256
with ``SGD(0.01)``, random images and labels from seed 0.

pipeline: BERT-base as above, plain and under ``PipelineOptimizer(Adam,
num_microbatches=4)``: each captured step's device breakdown, and one
eager step of each under ``cProfile`` (its wall ms and the functions that
take its host time).

``build_pretrain`` and ``build_transformer`` take a ``schedule``: BERT's
warmup and linear decay (``bert_schedule``) and the Transformer's noam
decay (``noam_schedule``), each with its float64 closed form
(``bert_schedule_lr``, ``noam_schedule_lr``). ``build_pretrain`` and
``build_resnet50`` take an ``optimizer`` (``lamb``: LAMB at its class
defaults, LayerNorm scales and biases excluded from weight decay;
``lars``: ``LarsMomentum(0.1, 0.9)`` at its defaults), and
``build_pretrain`` takes ``checkpoints=True``: ``RecomputeOptimizer`` over
it, with a checkpoint at each encoder layer's output
(``encoder_checkpoints``).

``build_pretrain``, ``pretrain_feed``, ``build_resnet50``, ``resnet_feed``,
``transformer_config``, ``build_transformer``, ``nmt_feed``,
``build_beam_decode``, ``decode_feed``, ``build_deepfm``, ``deepfm_feed``,
``build_mnist`` and ``mnist_feed`` are what ``chip_smoke.py`` drives.
"""
from __future__ import annotations

import contextlib
import json
import time

import numpy as np

#: idle seconds inside a profiler window before its work starts and after it
#: ends: a window whose device work starts as it opens can come back missing
#: its first records, or all of them (``python3 -m
#: paddle_tpu_torch.tools.trace_probe`` counts both ways)
TRACE_MARGIN_S = 0.05

#: bench.py::bench_bert_base's pretraining configuration (BATCH and SEED are
#: bench_resnet50's too)
BATCH, SEQ, MASKS_PER_SEQ, LR, SEED = 128, 128, 20, 1e-4, 0
#: BERT's published schedule (``bert_schedule``) and the Transformer's (``noam_schedule``)
BERT_PEAK_LR, BERT_WARMUP, BERT_DECAY_STEPS = 1e-4, 10_000, 1_000_000
NOAM_D_MODEL, NOAM_WARMUP = 512, 4000
#: bench.py::bench_resnet50's image size and classes
IMAGE, CLASSES = 224, 1000
FEEDS = (("src_ids", "int64", "seq"), ("pos_ids", "int64", "seq"),
         ("sent_ids", "int64", "seq"), ("input_mask", "float32", "seq"),
         ("mask_pos", "int64", "masks"), ("mask_label", "int64", "masks"),
         ("nsp_label", "int64", "batch"))


def bert_schedule(layers):
    """BERT's learning rate (Devlin et al. 2018, appendix A.2; google-research
    bert ``optimization.py::create_optimizer``): 1e-4, 10,000 warmup steps
    from 0, then linear decay to 0 at 1,000,000 steps."""
    return layers.linear_lr_warmup(
        layers.polynomial_decay(BERT_PEAK_LR, decay_steps=BERT_DECAY_STEPS,
                                end_learning_rate=0.0, power=1.0),
        warmup_steps=BERT_WARMUP, start_lr=0.0, end_lr=BERT_PEAK_LR)


def bert_schedule_lr(counter: int) -> float:
    """``bert_schedule``'s learning rate in a run that starts with the step
    counter at ``counter``, in float64: the schedule nests two schedules,
    each of which advances the counter once a run (the JAX package's
    behaviour), so the decay reads counter + 1 and the warmup counter + 2."""
    decay = BERT_PEAK_LR * (1 - min(counter + 1, BERT_DECAY_STEPS) / BERT_DECAY_STEPS)
    warm = (counter + 2) * (BERT_PEAK_LR / BERT_WARMUP)
    return warm if counter + 2 < BERT_WARMUP else decay


def noam_schedule(layers):
    """The Transformer's learning rate (Vaswani et al. 2017, section 5.3):
    d_model^-0.5 min(step^-0.5, step warmup^-1.5), d_model 512, 4000 warmup
    steps."""
    return layers.noam_decay(NOAM_D_MODEL, NOAM_WARMUP)


def noam_schedule_lr(counter: int) -> float:
    """``noam_schedule``'s learning rate in a run that starts with the step
    counter at ``counter`` (it reads counter + 1), in float64."""
    step = counter + 1
    return NOAM_D_MODEL ** -0.5 * min(step ** -0.5, step * NOAM_WARMUP ** -1.5)


def lamb(pt, rate):
    """LAMB at its class defaults (weight decay 0.01, beta1 0.9, beta2 0.999,
    epsilon 1e-6: You et al. 2019, arXiv:1904.00962), with the LayerNorm
    scales and biases (``layer_norm_N.w_0`` / ``.b_0``) excluded from weight
    decay."""
    return pt.optimizer.Lamb(rate, exclude_from_weight_decay_fn=lambda p: p.name.startswith(
        "layer_norm"))


def lars(pt, rate=0.1):
    """``LarsMomentum(rate, 0.9)`` at its defaults (lars_coeff 0.001,
    lars_weight_decay 0.0005, Paddle's own)."""
    return pt.optimizer.LarsMomentum(rate, 0.9)


def encoder_checkpoints(program, n_layers):
    """The output of each encoder layer of a BERT program: the second
    ``layer_norm`` of each layer (``models/bert.py::encoder_layer``), after
    the embeddings' one."""
    norms = [op for op in program.global_block().ops if op.type == "layer_norm"]
    return [norms[2 * (i + 1)].output("Y")[0] for i in range(n_layers)]


def pipeline(microbatches):
    """``optimizer(pt, rate)`` for the builders: ``PipelineOptimizer(Adam(rate),
    num_microbatches=microbatches, schedule="scan")``, gradient accumulation
    over equal slices of the batch on one card."""
    def make(pt, rate):
        return pt.optimizer.PipelineOptimizer(pt.optimizer.Adam(rate),
                                              num_microbatches=microbatches, schedule="scan")
    return make


def amp_adam(pt, rate):
    """``optimizer(pt, rate)`` for the builders: ``Adam(rate)`` under
    ``contrib.mixed_precision.decorate`` at its defaults (bf16, no loss
    scaling)."""
    return pt.contrib.mixed_precision.decorate(pt.optimizer.Adam(rate))


def build_pretrain(cfg, batch, seq, n_masks, lr=LR, seed=SEED, schedule=None, optimizer=None,
                   checkpoints=False, pkg=None, model=None):
    """The pretraining Program at static shapes (batch x seq tokens, n_masks
    masked positions per sequence) with ``Adam(lr)``, or with ``Adam`` at
    the learning rate that ``schedule(layers)`` builds (``bert_schedule``).
    ``optimizer(pt, rate)`` replaces ``Adam`` (``lamb``, ``pipeline(M)``);
    ``checkpoints`` wraps it in ``RecomputeOptimizer`` with
    ``encoder_checkpoints``. ``pkg`` and ``model`` are the DSL's package
    and its ``models.bert`` module, given together (the port's when None;
    the tests pass the JAX package's, with its own ``cfg``). Returns
    (main, startup, total_loss, params_grads)."""
    if pkg is None:
        import paddle_tpu_torch as pkg
        from paddle_tpu_torch.models import bert as model
    pt, bert = pkg, model
    M = batch * n_masks
    shapes = {"seq": [batch, seq], "masks": [M, 1], "batch": [batch, 1]}
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ins = [pt.data(n, shapes[kind], dt, append_batch_size=False)
               for n, dt, kind in FEEDS]
        total, _, _ = bert.pretrain(*ins, cfg)
        rate = schedule(pt.layers) if schedule is not None else lr
        opt = optimizer(pt, rate) if optimizer is not None else pt.optimizer.Adam(rate)
        if checkpoints:
            opt = pt.optimizer.RecomputeOptimizer(opt)._set_checkpoints(
                encoder_checkpoints(main, cfg.n_layers))
        _, params_grads = opt.minimize(total)
    return main, startup, total, params_grads


def pretrain_feed(rng, cfg, batch, seq, n_masks, microbatches=1):
    """One batch, drawn as bench.py draws it: random ids, positions, random
    segments, a full mask, random masked positions and labels.

    ``mask_pos`` holds flat indices into the batch's [batch * seq] tokens.
    Under ``microbatches`` = k > 1 (a ``PipelineOptimizer`` feed) the rewrite
    slices every feed into k equal parts, and each microbatch gathers from
    its own [batch / k * seq] tokens: so the positions are drawn in
    microbatch order, n_masks * batch / k for each, each relative to its own
    microbatch (as Paddle's multi-device BERT reader writes each device's
    batch). ``global_mask_pos`` turns them back into indices into the whole
    batch, for the same step without microbatches."""
    M = batch * n_masks
    if batch % microbatches:
        raise ValueError(f"batch {batch} does not split into {microbatches} microbatches")
    return {"src_ids": rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "sent_ids": rng.randint(0, 2, (batch, seq)).astype("int64"),
            "input_mask": np.ones((batch, seq), "float32"),
            "mask_pos": rng.randint(0, batch // microbatches * seq, (M, 1)).astype("int64"),
            "mask_label": rng.randint(0, cfg.vocab_size, (M, 1)).astype("int64"),
            "nsp_label": rng.randint(0, 2, (batch, 1)).astype("int64")}


def global_mask_pos(mask_pos, microbatches, batch, seq):
    """Microbatch-relative masked positions (``pretrain_feed(...,
    microbatches)``) as indices into the whole batch's tokens: the m-th
    equal block of rows offset by m * batch / microbatches * seq."""
    rows = mask_pos.shape[0] // microbatches
    offset = np.repeat(np.arange(microbatches, dtype=mask_pos.dtype) * (batch // microbatches
                                                                        * seq), rows)
    return mask_pos + offset.reshape((-1,) + (1,) * (mask_pos.ndim - 1))


def build_resnet50(dtype="bfloat16", fuse=True, optimizer=None):
    """ResNet-50 training at bench.py's configuration (NHWC, space-to-depth
    stem, 224 x 224, 1000 classes, ``Momentum(0.1, 0.9)``, seed 0, dynamic
    batch) in ``dtype``; ``fuse`` marks every batch norm ``fuse_stats`` and
    runs the fuse pass before ``minimize``; ``optimizer(pt)`` replaces
    ``Momentum`` (``lars``). Returns (main, startup, loss, params_grads,
    chains fused)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib import fuse_conv_bn_stats
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    main.random_seed = SEED
    startup.random_seed = SEED
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [IMAGE, IMAGE, 3], dtype)
        label = pt.data("label", [1], "int64")
        loss, _, _ = resnet.resnet50(img, label, num_classes=CLASSES, data_format="NHWC",
                                     conv1_space_to_depth=True)
        fused = 0
        if fuse:
            for op in main.global_block().ops:
                if op.type == "batch_norm":
                    op.attrs["fuse_stats"] = True
            fused = fuse_conv_bn_stats(main)
        opt = optimizer(pt) if optimizer is not None else pt.optimizer.Momentum(0.1, 0.9)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads, fused


def resnet_feed(rng, batch):
    """One batch as bench.py draws it: NCHW normal images made channels-last
    (f32; the executor casts nothing, so cast to the program's dtype), and
    random labels."""
    img = rng.randn(batch, 3, IMAGE, IMAGE).astype(np.float32)
    return {"img": np.ascontiguousarray(img.transpose(0, 2, 3, 1)),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype("int64")}


#: bench_workloads.py::bench_transformer's configuration
NMT_BATCH, NMT_SEQ, NMT_LR, NMT_LABEL_SMOOTH = 64, 64, 1e-4, 0.1
NMT_FEEDS = (("src", "int64"), ("spos", "int64"), ("smask", "float32"), ("trg", "int64"),
             ("tpos", "int64"), ("tmask", "float32"), ("lbl", "int64"))


def transformer_config(dropout=0.1):
    """transformer-base at bench_workloads.py's widths."""
    from paddle_tpu_torch.models import transformer
    return transformer.TransformerConfig(src_vocab=32000, trg_vocab=32000, hidden=512,
                                         n_layers=6, n_heads=8, ffn_hidden=2048,
                                         dropout=dropout)


def build_transformer(cfg, batch=NMT_BATCH, seq=NMT_SEQ, lr=NMT_LR, seed=SEED, schedule=None,
                      optimizer=None, pkg=None, model=None):
    """The training Program at static shapes (batch x seq source and target
    tokens), label smoothing 0.1, ``Adam(lr)`` or ``Adam`` at the learning
    rate ``schedule(layers)`` builds (``noam_schedule``); ``optimizer(pt,
    rate)`` replaces ``Adam`` (``amp_adam``). ``pkg`` and ``model`` (its
    ``models.transformer``) as ``build_pretrain``'s. Returns (main, startup,
    loss, params_grads)."""
    if pkg is None:
        import paddle_tpu_torch as pkg
        from paddle_tpu_torch.models import transformer as model
    pt, transformer = pkg, model
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ins = [pt.data(n, [batch, seq], dt, append_batch_size=False) for n, dt in NMT_FEEDS]
        loss, _ = transformer.transformer(*ins, cfg, label_smooth_eps=NMT_LABEL_SMOOTH)
        rate = schedule(pt.layers) if schedule is not None else lr
        opt = optimizer(pt, rate) if optimizer is not None else pt.optimizer.Adam(rate)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


def nmt_feed(rng, cfg, batch=NMT_BATCH, seq=NMT_SEQ):
    """One batch as bench_workloads.py draws it: random source, target and
    label ids, positions, full masks."""
    pos = np.tile(np.arange(seq, dtype="int64"), (batch, 1))
    ones = np.ones((batch, seq), "float32")
    ids = lambda vocab: rng.randint(0, vocab, (batch, seq)).astype("int64")
    return {"src": ids(cfg.src_vocab), "spos": pos, "smask": ones,
            "trg": ids(cfg.trg_vocab), "tpos": pos, "tmask": ones,
            "lbl": ids(cfg.trg_vocab)}


def build_beam_decode(cfg, seq, beam_size, max_len, seed=SEED):
    """The beam-search decode Program (dynamic batch, source length
    ``seq``, bos 0, eos 1). Returns (main, startup, sentence ids, sentence
    scores, the scan op)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = pt.data("src", [seq], "int64")
        pos = pt.data("pos", [seq], "int64")
        mask = pt.data("mask", [seq], "float32")
        ids, scores = transformer.beam_decode(src, pos, mask, cfg, beam_size=beam_size,
                                              max_len=max_len, bos_id=0, eos_id=1)
    scan = next(op for op in main.global_block().ops if op.type == "scan")
    return main, startup, ids, scores, scan


def decode_feed(rng, cfg, batch, seq):
    """Source sentences of ragged lengths (the first full, the rest drawn
    from [seq/4, seq]): ids in [2, vocab) (0 and 1 are bos and eos), 0 past
    the end, a 1/0 mask."""
    lengths = rng.randint(seq // 4, seq + 1, batch)
    lengths[0] = seq
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype("float32")
    src = rng.randint(2, cfg.src_vocab, (batch, seq)).astype("int64") * mask.astype("int64")
    return {"src": src, "pos": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "mask": mask}


#: bench_workloads.py::bench_deepfm's configuration
CTR_BATCH, CTR_FIELDS, CTR_VOCAB, CTR_EMBED, CTR_DENSE, CTR_LR = 4096, 26, 1_000_000, 16, 13, 1e-3


def build_deepfm(batch=CTR_BATCH, fields=CTR_FIELDS, vocab=CTR_VOCAB, embed=CTR_EMBED,
                 lr=CTR_LR, seed=SEED):
    """The DeepFM training Program at static shapes (tower 400-400-400, the
    ``auc`` metric) with ``Adam(lr)``. Returns (main, startup, loss, auc,
    prob, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import deepfm
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.data("ids", [batch, fields], "int64", append_batch_size=False)
        dense = pt.data("dense", [batch, CTR_DENSE], "float32", append_batch_size=False)
        label = pt.data("label", [batch, 1], "int64", append_batch_size=False)
        loss, auc, prob = deepfm.deepfm(ids, dense, label, num_fields=fields,
                                        vocab_size=vocab, embed_dim=embed)
        _, params_grads = pt.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss, auc, prob, params_grads


def deepfm_feed(rng, batch=CTR_BATCH, fields=CTR_FIELDS, vocab=CTR_VOCAB):
    """One batch as bench_workloads.py draws it: random ids, dense features
    in [0, 1) and labels in {0, 1} (ids and labels int64; the JAX package
    feeds them as int32)."""
    return {"ids": rng.randint(0, vocab, (batch, fields)).astype("int64"),
            "dense": rng.rand(batch, CTR_DENSE).astype(np.float32),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


#: the MNIST MLP: examples/mnist_mlp.py's batch, tests/test_book_chapters.py's SGD
MNIST_BATCH, MNIST_LR, MNIST_PIXELS, MNIST_CLASSES = 256, 0.01, 784, 10


def build_mnist(batch=MNIST_BATCH, lr=MNIST_LR, seed=SEED, clip_norm=None, l2=None,
                optimizer=None, pkg=None, model=None):
    """The MNIST MLP training Program at a static batch with ``SGD(lr)``;
    ``clip_norm`` sets ``GradientClipByGlobalNorm(clip_norm)`` on every
    parameter and ``l2`` the optimizer's ``L2Decay(l2)``; ``optimizer(pt)``
    replaces ``SGD`` (anything with a ``minimize(loss)`` that returns
    (ops, params_grads)). ``pkg`` and ``model`` (its ``models.mnist``) as
    ``build_pretrain``'s. Returns (main, startup, loss, acc, params_grads)."""
    if pkg is None:
        import paddle_tpu_torch as pkg
        from paddle_tpu_torch.models import mnist as model
    pt, mnist = pkg, model
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [batch, MNIST_PIXELS], "float32", append_batch_size=False)
        label = pt.data("label", [batch, 1], "int64", append_batch_size=False)
        loss, acc, _ = mnist.mlp(img, label)
        if clip_norm is not None:
            pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(clip_norm))
        reg = pt.regularizer.L2Decay(l2) if l2 is not None else None
        opt = optimizer(pt) if optimizer is not None else pt.optimizer.SGD(
            lr, regularization=reg)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, acc, params_grads


def mnist_feed(rng, batch=MNIST_BATCH):
    """Random images in [0, 1) and labels (no dataset file is read)."""
    return {"img": rng.rand(batch, MNIST_PIXELS).astype(np.float32),
            "label": rng.randint(0, MNIST_CLASSES, (batch, 1)).astype("int64")}


# device activity name -> kind, by the first pattern it contains
KINDS = (("row gradients (index_put_ accumulate)", ("indexing_backward",)),
         ("sorts (cub radix sort)", ("RadixSort", "radix_sort")),
         ("row gathers (index_select)", ("indexSelect",)),
         ("conv1x1_bn kernels", ("conv1x1_bn", "column_sums")),
         ("multi-tensor update", ("multi_tensor_kernel",)),
         ("dropout kernel", ("dropout_kernel",)),
         ("attention kernels", ("flash_fwd", "bwd_dkdv", "bwd_dq", "delta_f32")),
         ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn", "convolve",
                                   "implicit_gemm")),
         ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
         ("copy", ("copy", "Memcpy", "Memset")))


def _kind(name):
    return next((k for k, pats in KINDS if any(p in name for p in pats)),
                "other (elementwise, reductions)")


@contextlib.contextmanager
def traced(activities, margin=TRACE_MARGIN_S, schedule=None):
    """``torch.profiler.profile(activities=..., schedule=...)`` with
    ``margin`` idle seconds inside the window on either side of the body;
    the body waits for its device work before it ends."""
    from torch.profiler import profile
    with profile(activities=activities, schedule=schedule) as prof:
        time.sleep(margin)
        yield prof
        time.sleep(margin)


#: traces of a window before ``profile_steps`` gives up: a whole window can
#: come back with no device record at all (ROADMAP fault 3.2), and the steps
#: it traces are traced again
PROFILE_TRIES = 3


def _trace_window(exe, main, feed, fetch, n_steps):
    """One profiler window over ``n_steps`` runs: (wall seconds a step, the
    device records as (us a step, count a step, name))."""
    from torch.profiler import ProfilerActivity, schedule
    # one step traced and dropped first (the profiler's warm-up): late in a long
    # process a trace loses its first 15-20 device records (ROADMAP fault 3.2)
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=n_steps, repeat=1)) as prof:
        exe.run(main, feed=feed, fetch_list=fetch)
        prof.step()
        t0 = time.perf_counter()
        for i in range(n_steps):
            exe.run(main, feed=feed, fetch_list=fetch)     # numpy: the step is done
            if i + 1 < n_steps:
                prof.step()
        wall = (time.perf_counter() - t0) / n_steps
        prof.step()            # ends the traced steps (outside the timed wall)
    device = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # device activities carry no CPU time; the step marks that the schedule
        # adds ("ProfilerStep*") span the steps on the device's clock, no work
        if us > 0 and e.cpu_time_total == 0 and not e.key.startswith("ProfilerStep"):
            device.append((us / n_steps, e.count / n_steps, e.key))
    return wall, device


def profile_steps(torch, exe, main, feed, total, n_steps):
    """Trace ``n_steps`` runs of ``main`` fetching ``total`` (a variable or a
    list of them, as the runs before fetched, so that the executor's cached
    graph is the one replayed), after one more run that the profiler traces
    and drops; device time by activity name, and the window's count of
    device records by name (``device_records``) and their device ms a step
    (``device_ms_by_record``). A window with no device
    record is traced again, up to PROFILE_TRIES windows in all
    (``empty_windows`` counts the ones dropped); then it raises."""
    fetch = list(total) if isinstance(total, (list, tuple)) else [total]
    empty = 0
    for _ in range(PROFILE_TRIES):
        wall, device = _trace_window(exe, main, feed, fetch, n_steps)
        if device:
            break
        empty += 1
    else:
        raise SystemExit(f"torch.profiler recorded no device activity in {PROFILE_TRIES} "
                         f"windows: device busy time not measured")
    device.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in device) / 1e3
    by_kind = {}
    for us, c, k in device:
        ms, n = by_kind.get(_kind(k), (0.0, 0.0))
        by_kind[_kind(k)] = (ms + us / 1e3, n + c)
    records, record_ms = {}, {}
    for us, c, k in device:
        records[k[:120]] = records.get(k[:120], 0) + round(c * n_steps)
        record_ms[k[:120]] = record_ms.get(k[:120], 0.0) + us / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms, "empty_windows": empty,
            "device_idle_share": max(0.0, 1 - busy_ms / (wall * 1e3)),
            "device_activities_per_step": sum(c for _, c, _ in device),
            "device_records": records, "device_ms_by_record": record_ms,
            "by_kind": {k: {"ms": ms, "per_step": n} for k, (ms, n) in by_kind.items()},
            "top": [{"name": k[:90], "ms": us / 1e3, "per_step": c}
                    for us, c, k in device[:15]]}


def main_resnet50(torch):
    import paddle_tpu_torch as pt
    main_prog, startup, loss, _, fused = build_resnet50()
    raw = resnet_feed(np.random.RandomState(SEED), BATCH)
    feed = {"img": torch.from_numpy(raw["img"]).to("cuda", torch.bfloat16),
            "label": torch.from_numpy(raw["label"]).to("cuda")}
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, loss, 3)
    print(json.dumps({"profile": f"resnet50 NHWC s2d bf16 B{BATCH} 224x224 Momentum, "
                                 f"{fused} conv+bn chains fused",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


def main_transformer(torch):
    import paddle_tpu_torch as pt
    cfg = transformer_config()
    main_prog, startup, loss, _ = build_transformer(cfg)
    feed = nmt_feed(np.random.RandomState(SEED), cfg)
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, loss, 3)
    print(json.dumps({"profile": f"transformer-base f32 B{NMT_BATCH} S{NMT_SEQ}+{NMT_SEQ} "
                                 f"dropout {cfg.dropout} Adam({NMT_LR})",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


def main_deepfm(torch):
    import paddle_tpu_torch as pt
    main_prog, startup, loss, _, _, _ = build_deepfm()
    feed = deepfm_feed(np.random.RandomState(SEED))
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, loss, 3)
    print(json.dumps({"profile": f"deepfm f32 B{CTR_BATCH} fields {CTR_FIELDS} vocab "
                                 f"{CTR_VOCAB} embed {CTR_EMBED} tower 400-400-400 auc "
                                 f"Adam({CTR_LR})",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


def main_mnist(torch):
    import paddle_tpu_torch as pt
    main_prog, startup, loss, _, _ = build_mnist()
    feed = mnist_feed(np.random.RandomState(SEED))
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, loss, 3)
    print(json.dumps({"profile": f"mnist mlp 784-128-64-10 f32 B{MNIST_BATCH} SGD({MNIST_LR})",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


def eager_host_profile(torch, exe, main_prog, feed, total, top=20):
    """One eager step of ``main_prog`` under ``cProfile``: its wall ms and
    the ``top`` functions by cumulative host time (ms, calls)."""
    import cProfile
    import pstats
    exe._use_graphs = False
    exe.run(main_prog, feed=feed, fetch_list=[total])
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    exe.run(main_prog, feed=feed, fetch_list=[total])
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((ct, nc, f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}({fn[2]})")
                   for fn, (cc, nc, tt, ct, callers) in stats.items()), reverse=True)
    return {"eager_wall_ms": wall,
            "top_cumulative": [{"fn": f, "ms": ct * 1e3, "calls": nc} for ct, nc, f in rows[:top]]}


def main_pipeline(torch):
    """BERT-base pretraining at bench.py's configuration under
    ``PipelineOptimizer(Adam, num_microbatches=4)`` (``pipeline``): the
    captured step's device breakdown, and one eager step's host time by
    function beside the plain step's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(dtype="bfloat16")
    out = {}
    for label, microbatches in (("plain", 1), ("pipeline", 4)):
        main_prog, startup, total, _ = build_pretrain(
            cfg, BATCH, SEQ, MASKS_PER_SEQ,
            optimizer=pipeline(microbatches) if microbatches > 1 else None)
        feed = {k: torch.from_numpy(v).cuda() for k, v in pretrain_feed(
            np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ, microbatches).items()}
        exe = pt.Executor()
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            for _ in range(2):
                exe.run(main_prog, feed=feed, fetch_list=[total])
            torch.cuda.synchronize()
            r = profile_steps(torch, exe, main_prog, feed, total, 3)
            r.pop("device_records")
            r.pop("device_ms_by_record")
            r.update(eager_host_profile(torch, exe, main_prog, feed, total))
        exe.close()
        out[label] = r
    print(json.dumps({"profile": f"bert-base pretrain L{cfg.n_layers} bf16 B{BATCH} S{SEQ}, "
                                 f"plain and PipelineOptimizer(Adam, 4 microbatches)",
                      "gpu": torch.cuda.get_device_name(0), **out}), flush=True)


def main():
    import sys
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device")
    if sys.argv[1:] == ["pipeline"]:
        return main_pipeline(torch)
    if sys.argv[1:] == ["resnet50"]:
        return main_resnet50(torch)
    if sys.argv[1:] == ["transformer"]:
        return main_transformer(torch)
    if sys.argv[1:] == ["deepfm"]:
        return main_deepfm(torch)
    if sys.argv[1:] == ["mnist"]:
        return main_mnist(torch)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(dtype="bfloat16")
    main_prog, startup, total, _ = build_pretrain(cfg, BATCH, SEQ, MASKS_PER_SEQ)
    feed = pretrain_feed(np.random.RandomState(SEED), cfg, BATCH, SEQ, MASKS_PER_SEQ)
    exe = pt.Executor()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main_prog, feed=feed, fetch_list=[total])
        torch.cuda.synchronize()
        r = profile_steps(torch, exe, main_prog, feed, total, 3)
    print(json.dumps({"profile": f"bert-base pretrain L{cfg.n_layers} bf16 B{BATCH} S{SEQ} "
                                 f"masks {BATCH * MASKS_PER_SEQ} Adam",
                      "gpu": torch.cuda.get_device_name(0), **r}), flush=True)


if __name__ == "__main__":
    main()
