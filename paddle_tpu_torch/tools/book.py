"""The book chapters of ``examples/`` as programs, data and training
schedules, at each example's own configuration.

``build_<chapter>(pkg, ...)`` builds the example's programs with the DSL of
``pkg``: the port, ``paddle_tpu_torch``, or a package with the same surface
(the tests pass the JAX package, to hold the two against each other on
equal weights). Its defaults are the example's constants, and it returns a
``Chapter``. Every program sets ``random_seed`` 0 and names its variables
under ``unique_name.guard()``, so that weights carry across by name (the
MNIST, word2vec and image chapters leave the seed unset).
``<chapter>_feeds(...)`` gives the feeds of the example's training
schedule in the example's order (and its test feeds where the example
evaluates), read from the port's loaders (``paddle_tpu_torch.dataset``, or
``ds``). ``chip_smoke.py``'s phase 16 trains every chapter on the card
with these, and ``tests/test_torch_book_chapters.py`` cuts them to a few
steps on the CPU.
"""
from __future__ import annotations

import numpy as np


class Chapter:
    """One chapter's programs: ``main`` (the training step), ``startup``,
    ``loss``, ``metric`` (the variable the example fetches besides the
    loss, or None) and ``test`` (a ``for_test`` clone taken before the
    optimizer, or None)."""

    def __init__(self, name, main, startup, loss, metric=None, test=None):
        self.name, self.main, self.startup = name, main, startup
        self.loss, self.metric, self.test = loss, metric, test

    @property
    def fetch(self):
        return [self.loss] + ([self.metric] if self.metric is not None else [])


def _programs(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 0
    startup.random_seed = 0
    return main, startup


def _datasets(ds):
    if ds is None:
        from .. import dataset as ds
    return ds


# -- fit_a_line (examples/fit_a_line.py) ----------------------------------------------------

FIT_BATCH, FIT_EPOCHS, FIT_LR = 64, 30, 0.01


def build_fit_a_line(pkg, lr=FIT_LR):
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [13], "float32")
        y = pkg.data("y", [1], "float32")
        pred = pkg.layers.fc(x, 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(lr).minimize(loss)
    return Chapter("fit_a_line", main, startup, loss, pred)


def fit_a_line_feeds(ds=None, batch=FIT_BATCH, epochs=FIT_EPOCHS):
    ds = _datasets(ds)
    rows = list(ds.uci_housing.train()())
    X = np.stack([np.asarray(x, "float32") for x, _ in rows])
    Y = np.stack([np.asarray(y, "float32") for _, y in rows]).reshape(-1, 1)
    one = [{"x": X[i:i + batch], "y": Y[i:i + batch]}
           for i in range(0, len(X) - batch + 1, batch)]
    return one * epochs


# -- understand_sentiment (examples/understand_sentiment.py) -----------------------------

SENT_MAX_LEN, SENT_HID, SENT_EMB = 96, 64, 64
SENT_BATCH, SENT_EPOCHS, SENT_LR, SENT_TRAIN, SENT_TEST = 64, 6, 2e-3, 1024, 256


def build_understand_sentiment(pkg, vocab, max_len=SENT_MAX_LEN, hid=SENT_HID, emb=SENT_EMB,
                               lr=SENT_LR):
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        data = pkg.data("words", [-1, max_len], "int64", **A)
        length = pkg.data("length", [-1], "int64", **A)
        label = pkg.data("label", [-1, 1], "int64", **A)
        e = pkg.layers.embedding(data, [vocab, emb])
        proj = pkg.layers.fc(e, hid * 4, num_flatten_dims=2)
        h, _ = pkg.layers.dynamic_lstm(proj, hid * 4, length=length)
        pooled = pkg.layers.sequence_pool(h, "max", length=length)
        logits = pkg.layers.fc(pooled, 2)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        acc = pkg.layers.accuracy(logits, label)
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("understand_sentiment", main, startup, loss, acc)


def _sentiment_rows(ds, word_idx, split, limit, max_len):
    """(ids [N, max_len], lengths [N], labels [N, 1]) as the example loads them."""
    reader = (ds.imdb.train if split == "train" else ds.imdb.test)(word_idx)
    ids, lens, labels = [], [], []
    for words, label in reader():
        words = words[:max_len]
        lens.append(len(words))
        ids.append(words + [0] * (max_len - len(words)))
        labels.append(label)
        if len(ids) >= limit:
            break
    return (np.array(ids, "int64"), np.array(lens, "int64"),
            np.array(labels, "int64")[:, None])


def _sentiment_batches(rows, batch):
    ids, lens, labels = rows
    return [{"words": ids[i:i + batch], "length": lens[i:i + batch],
             "label": labels[i:i + batch]} for i in range(0, len(ids) - batch + 1, batch)]


def sentiment_feeds(ds=None, batch=SENT_BATCH, epochs=SENT_EPOCHS, n_train=SENT_TRAIN,
                    n_test=SENT_TEST, max_len=SENT_MAX_LEN):
    """(vocabulary size, the training feeds, the test feeds)."""
    ds = _datasets(ds)
    word_idx = ds.imdb.word_dict()
    train = _sentiment_batches(_sentiment_rows(ds, word_idx, "train", n_train, max_len), batch)
    test = _sentiment_batches(_sentiment_rows(ds, word_idx, "test", n_test, max_len), batch)
    return len(word_idx), train * epochs, test


# -- label_semantic_roles (examples/label_semantic_roles.py) ------------------------------

SRL_MAX_LEN, SRL_EMB, SRL_HID, SRL_DEPTH = 20, 32, 64, 2
SRL_BATCH, SRL_EPOCHS, SRL_LR, SRL_ROWS = 64, 8, 5e-3, 512
SRL_FEATURES = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "verb", "mark"]


def build_label_semantic_roles(pkg, n_words, n_verbs, n_labels, max_len=SRL_MAX_LEN,
                               emb=SRL_EMB, hid=SRL_HID, depth=SRL_DEPTH, lr=SRL_LR):
    """The stacked bidirectional LSTM with a CRF head; ``metric`` is the
    Viterbi path."""
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        feats = [pkg.data(n, [-1, max_len], "int64", **A) for n in SRL_FEATURES]
        length = pkg.data("length", [-1], "int64", **A)
        label = pkg.data("label", [-1, max_len], "int64", **A)
        vocab_of = dict.fromkeys(SRL_FEATURES[:6], n_words)
        vocab_of.update(verb=n_verbs, mark=2)
        embs = [pkg.layers.embedding(f, [vocab_of[n], emb]) for n, f in zip(SRL_FEATURES, feats)]
        h = pkg.layers.fc(pkg.layers.sum(embs), hid, num_flatten_dims=2)
        for _ in range(depth):
            fwd, _ = pkg.layers.dynamic_lstm(h, hid, length=length)
            rev, _ = pkg.layers.dynamic_lstm(h, hid, length=length, is_reverse=True)
            h = pkg.layers.fc(pkg.layers.concat([fwd, rev], axis=2), hid, num_flatten_dims=2)
        emission = pkg.layers.fc(h, n_labels, num_flatten_dims=2)
        crf_attr = pkg.ParamAttr(name="crfw")
        nll = pkg.layers.linear_chain_crf(emission, label, param_attr=crf_attr, length=length)
        loss = pkg.layers.mean(nll)
        path = pkg.layers.crf_decoding(emission, crf_attr, length=length)
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("label_semantic_roles", main, startup, loss, path)


def srl_feeds(ds=None, batch=SRL_BATCH, epochs=SRL_EPOCHS, limit=SRL_ROWS,
              max_len=SRL_MAX_LEN):
    """((words, verbs, labels) dictionary sizes, the training feeds)."""
    ds = _datasets(ds)
    word_dict, verb_dict, label_dict = ds.conll05.get_dict()
    feats, lens, labels = [], [], []
    for slots in ds.conll05.test()():
        *feat8, lab = slots
        n = min(len(lab), max_len)
        feats.append([list(f[:n]) + [0] * (max_len - n) for f in feat8])
        labels.append(list(lab[:n]) + [0] * (max_len - n))
        lens.append(n)
        if len(feats) >= limit:
            break
    feats, lens, labels = (np.array(feats, "int64"), np.array(lens, "int64"),
                           np.array(labels, "int64"))
    one = []
    for i in range(0, len(feats) - batch + 1, batch):
        feed = {n: feats[i:i + batch, j] for j, n in enumerate(SRL_FEATURES)}
        feed["length"], feed["label"] = lens[i:i + batch], labels[i:i + batch]
        one.append(feed)
    return (len(word_dict), len(verb_dict), len(label_dict)), one * epochs


def viterbi_accuracy(path, feed):
    """Token accuracy of a Viterbi path over each row's first ``length`` steps."""
    path, lens, labels = np.asarray(path), feed["length"], feed["label"]
    correct = sum(int((path[b, :n] == labels[b, :n]).sum()) for b, n in enumerate(lens))
    return correct / int(np.sum(lens))


# -- recommender_system (examples/recommender_system.py) ----------------------------------

REC_EMB, REC_TITLE_LEN, REC_MAX_CATS = 16, 8, 4
REC_BATCH, REC_EPOCHS, REC_LR, REC_TRAIN, REC_TEST = 256, 12, 2e-3, 24000, 512
REC_FEEDS = ("uid", "gender", "age", "job", "mid", "cat", "title", "title_len", "rating")


def build_recommender_system(pkg, n_users, n_movies, n_jobs, n_cats, n_title, emb=REC_EMB,
                             title_len=REC_TITLE_LEN, max_cats=REC_MAX_CATS, lr=REC_LR):
    main, startup = _programs(pkg)
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        uid, gender, age, job, mid = (pkg.data(n, [-1, 1], "int64", **A)
                                      for n in REC_FEEDS[:5])
        cat = pkg.data("cat", [-1, max_cats], "int64", **A)
        title = pkg.data("title", [-1, title_len], "int64", **A)
        tlen = pkg.data("title_len", [-1], "int64", **A)
        rating = pkg.data("rating", [-1, 1], "float32", **A)

        def tower_feature(ids, vocab, width=emb):
            e = L.embedding(ids, [vocab, width])
            return L.fc(L.reshape(e, [-1, width]), width)

        usr = L.concat([tower_feature(uid, n_users + 1, 32), tower_feature(gender, 2),
                        tower_feature(age, 8), tower_feature(job, n_jobs + 1)], axis=1)
        usr = L.fc(usr, 200, act="tanh")
        mov_id_f = tower_feature(mid, n_movies + 1, 32)
        cat_f = L.reduce_sum(L.embedding(cat, [n_cats + 1, 32]), dim=1)
        title_emb = L.embedding(title, [n_title + 1, 32])
        title_conv = L.sequence_conv(title_emb, 32, filter_size=3, length=tlen)
        title_f = L.sequence_pool(title_conv, "sum", length=tlen)
        mov = L.fc(L.concat([mov_id_f, cat_f, title_f], axis=1), 200, act="tanh")
        pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
        loss = L.mean(L.square_error_cost(pred, rating))
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("recommender_system", main, startup, loss)


def _recommender_rows(ds, split, limit):
    reader = (ds.movielens.train if split == "train" else ds.movielens.test)()
    rows = {k: [] for k in REC_FEEDS}
    pad_cat = ds.movielens.movie_categories()   # reserved id: vocabulary n + 1
    for uid, gender, age, job, mid, cats, title, rating in (tuple(r) for r in reader()):
        for k, v in (("uid", uid), ("gender", gender), ("age", age), ("job", job),
                     ("mid", mid)):
            rows[k].append([v])
        rows["cat"].append((list(cats) + [pad_cat] * REC_MAX_CATS)[:REC_MAX_CATS])
        rows["title"].append((list(title) + [0] * REC_TITLE_LEN)[:REC_TITLE_LEN])
        rows["title_len"].append(min(len(title), REC_TITLE_LEN))
        rows["rating"].append([rating[0]])
        if len(rows["uid"]) >= limit:
            break
    out = {k: np.array(v, "int64") for k, v in rows.items() if k != "rating"}
    out["rating"] = np.array(rows["rating"], "float32")
    return out


def recommender_feeds(ds=None, batch=REC_BATCH, epochs=REC_EPOCHS, n_train=REC_TRAIN,
                      n_test=REC_TEST):
    """((users, movies, jobs, categories, title words), the training feeds,
    the test feeds)."""
    ds = _datasets(ds)
    train, test = _recommender_rows(ds, "train", n_train), _recommender_rows(ds, "test", n_test)
    sizes = (ds.movielens.max_user_id(), ds.movielens.max_movie_id(),
             ds.movielens.max_job_id(), ds.movielens.movie_categories(),
             len(ds.movielens.get_movie_title_dict()))

    def cut(rows):
        n = len(rows["uid"])
        return [{k: v[i:i + batch] for k, v in rows.items()}
                for i in range(0, n - batch + 1, batch)]

    return sizes, cut(train) * epochs, cut(test)


# -- mnist_mlp (examples/mnist_mlp.py) ------------------------------------------------------

MNIST_BATCH, MNIST_EPOCHS, MNIST_LR, MNIST_HIDDEN, MNIST_TEST = 256, 2, 2e-3, 200, 1024
SHUFFLE_BUF = 4096


def build_mnist_mlp(pkg, lr=MNIST_LR, hidden=MNIST_HIDDEN):
    """The MLP; ``test`` is the example's ``clone(for_test=True)``, taken
    before ``minimize``; ``metric`` the accuracy of the softmax."""
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [784], "float32")
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.fc(img, hidden, act="relu")
        logits = pkg.layers.fc(h, 10)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        acc = pkg.layers.accuracy(pkg.layers.softmax(logits), label)
        test = main.clone(for_test=True)
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("mnist_mlp", main, startup, loss, acc, test)


def _image_feeds(reader, batch, epochs, shape, seed):
    """The example's ``reader.batch(reader.shuffle(train, 4096), batch,
    drop_last=True)`` over ``epochs``, shuffled from ``seed``."""
    from .. import reader as reader_mod
    batched = reader_mod.batch(reader_mod.shuffle(reader, buf_size=SHUFFLE_BUF, seed=seed),
                               batch_size=batch, drop_last=True)
    feeds = []
    for _ in range(epochs):
        for b in batched():
            feeds.append({"img": np.stack([s[0] for s in b]).reshape((-1,) + shape)
                          .astype("float32"),
                          "label": np.array([[s[1]] for s in b], "int64")})
    return feeds


def mnist_feeds(ds=None, batch=MNIST_BATCH, epochs=MNIST_EPOCHS, seed=0):
    """(the training feeds, the test feed: the first 1024 test rows)."""
    ds = _datasets(ds)
    train = _image_feeds(ds.mnist.train(), batch, epochs, (784,), seed)
    test_rows = []
    for row in ds.mnist.test()():
        test_rows.append(row)
        if len(test_rows) == MNIST_TEST:
            break
    test = {"img": np.stack([s[0] for s in test_rows]).astype("float32"),
            "label": np.array([[s[1]] for s in test_rows], "int64")}
    return train, test


# -- word2vec (examples/word2vec.py) --------------------------------------------------------

W2V_VOCAB, W2V_DIM, W2V_WIN, W2V_STEPS, W2V_BATCH, W2V_LR = 2000, 64, 2, 200, 256, 2e-3


def build_word2vec(pkg, vocab=W2V_VOCAB, dim=W2V_DIM, lr=W2V_LR):
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        center = pkg.data("center", [1], "int64")
        context = pkg.data("context", [1], "int64")
        e = pkg.layers.reshape(pkg.layers.embedding(center, (vocab, dim)), [-1, dim])
        logits = pkg.layers.fc(e, vocab)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, context))
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("word2vec", main, startup, loss)


def word2vec_feeds(steps=W2V_STEPS, batch=W2V_BATCH, vocab=W2V_VOCAB, win=W2V_WIN):
    """The example's synthetic skip-gram corpus (strong bigram structure,
    ``RandomState(0)``) and its batches, drawn as the example draws them."""
    rng = np.random.RandomState(0)
    corpus = [(w, (w * 7 + rng.randint(1, 1 + win)) % vocab)
              for w in rng.randint(0, vocab, 80_000)]
    feeds = []
    for _ in range(steps):
        b = [corpus[i] for i in rng.randint(0, len(corpus), batch)]
        feeds.append({"center": np.array([[c] for c, _ in b], "int64"),
                      "context": np.array([[t] for _, t in b], "int64")})
    return feeds


# -- machine_translation (examples/machine_translation.py) ------------------------------

MT_VOCAB, MT_HIDDEN, MT_LAYERS, MT_HEADS, MT_FFN = 120, 64, 2, 4, 128
MT_SEQ, MT_BATCH, MT_STEPS, MT_LR = 12, 32, 800, 2e-3
MT_FEEDS = (("src", "int64"), ("spos", "int64"), ("smask", "float32"), ("trg", "int64"),
            ("tpos", "int64"), ("tmask", "float32"), ("lbl", "int64"))


def build_machine_translation(pkg, transformer, seq=MT_SEQ, batch=MT_BATCH, lr=MT_LR,
                              n_layers=MT_LAYERS):
    """The compact Transformer of the example (``transformer``: the
    package's ``models.transformer`` module), dropout 0, no label smoothing."""
    cfg = transformer.TransformerConfig(src_vocab=MT_VOCAB, trg_vocab=MT_VOCAB,
                                        hidden=MT_HIDDEN, n_layers=n_layers,
                                        n_heads=MT_HEADS, ffn_hidden=MT_FFN, dropout=0.0)
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        v = {n: pkg.data(n, [batch, seq], dt, append_batch_size=False) for n, dt in MT_FEEDS}
        loss, _ = transformer.transformer(v["src"], v["spos"], v["smask"], v["trg"], v["tpos"],
                                          v["tmask"], v["lbl"], cfg, label_smooth_eps=0.0)
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("machine_translation", main, startup, loss)


def machine_translation_feeds(ds=None, steps=MT_STEPS, seq=MT_SEQ, batch=MT_BATCH):
    """The example's batches: pairs of ``wmt16.train(120, 120)`` padded to
    ``seq`` with 1, drawn by ``RandomState(0)``."""
    ds = _datasets(ds)
    pairs = []
    for s_ids, trg_in, trg_lbl in ds.wmt16.train(MT_VOCAB, MT_VOCAB)():
        def pad(xs):
            xs = list(xs)[:seq]
            return xs + [1] * (seq - len(xs)), min(len(xs), seq)
        sp, sl = pad(s_ids)
        tp, _ = pad(trg_in)
        lp, ll = pad(trg_lbl)
        pairs.append((sp, [1.0] * sl + [0.0] * (seq - sl), tp,
                      [1.0] * ll + [0.0] * (seq - ll), lp))
    pos = np.tile(np.arange(seq, dtype="int64"), (batch, 1))
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(steps):
        cols = list(zip(*(pairs[i] for i in rng.randint(0, len(pairs), batch))))
        feeds.append({"src": np.array(cols[0], "int64"), "spos": pos,
                      "smask": np.array(cols[1], "float32"), "trg": np.array(cols[2], "int64"),
                      "tpos": pos, "tmask": np.array(cols[3], "float32"),
                      "lbl": np.array(cols[4], "int64")})
    return feeds


# -- image_classification (examples/image_classification.py) ----------------------------

IMG_BATCH, IMG_STEPS, IMG_LR = 128, 100, 1e-3


def build_image_classification(pkg, vgg, lr=IMG_LR, dropout=0.5, hw=32):
    """VGG-16 with batch norm on CIFAR-10 shapes (``vgg``: the package's
    ``models.vgg`` module); ``metric`` the accuracy."""
    main, startup = _programs(pkg)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, hw, hw], "float32")
        label = pkg.data("label", [1], "int64")
        loss, acc, _ = vgg.vgg16(img, label, num_classes=10, use_bn=True, dropout=dropout)
        pkg.optimizer.Adam(lr).minimize(loss)
    return Chapter("image_classification", main, startup, loss, acc)


#: the input-gradient penalty's weight (double backpropagation, Drucker & LeCun 1992)
IMG_PENALTY = 0.1


def build_image_penalty(pkg, vgg, weight=IMG_PENALTY, lr=IMG_LR, dropout=0.5, hw=32):
    """The image chapter under an input-gradient penalty (double
    backpropagation, Drucker & LeCun 1992): total = loss + weight *
    mean over the batch of sum((d loss / d img)^2), the input gradient
    built by ``pkg.gradients``, so ``minimize`` differentiates through the
    first backward pass. Returns (the chapter, its ``loss`` the total, and
    the penalty variable)."""
    main, startup = _programs(pkg)
    layers = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, hw, hw], "float32")
        img.stop_gradient = False
        label = pkg.data("label", [1], "int64")
        loss, acc, _ = vgg.vgg16(img, label, num_classes=10, use_bn=True, dropout=dropout)
        gimg, = pkg.gradients([loss], [img])
        penalty = layers.mean(layers.reduce_sum(layers.square(gimg), dim=[1, 2, 3]))
        total = layers.elementwise_add(loss, layers.scale(penalty, scale=weight))
        pkg.optimizer.Adam(lr).minimize(total)
    return Chapter("image_classification_penalty", main, startup, total, acc), penalty


def image_classification_feeds(ds=None, batch=IMG_BATCH, steps=IMG_STEPS, seed=0):
    """The example's first ``steps`` batches of shuffled ``cifar.train10()``
    (epochs repeat until there are enough)."""
    ds = _datasets(ds)
    feeds = []
    while len(feeds) < steps:
        feeds += _image_feeds(ds.cifar.train10(), batch, 1, (3, 32, 32), seed + len(feeds))
    return feeds[:steps]

