"""The book chapters (``examples/``) on the port, held against the JAX
package on the CPU.

Each chapter is built by ``paddle_tpu_torch.tools.book`` in both packages
(the same ops in every block, the same parameters), its JAX startup state
is carried into the port by name (``convert.state_from_numpy``), and both
take the same first steps on the same feeds, read from the port's loaders
(``PADDLE_TPU_DATA_HOME`` points at an empty ``tmp_path``, so the
surrogates serve; ``tests/test_torch_book_datasets.py`` holds them row for
row to the JAX package's). The sentiment and SRL chapters run at the sizes
of ``tests/test_book_chapters.py``, machine_translation at one layer of
its two; the others at the example's own.

Tolerances: losses ``rtol 1e-4`` over 3 steps (f32 sums in other orders
through up to 48 LSTM steps, and Adam's first updates, lr * g / |g|,
amplify a gradient's rounding where |g| is tiny); accuracies and Viterbi
paths exactly; every state tensor ``atol 1e-4``. The learn-asserts of
``tests/test_book_chapters.py`` (fit_a_line, sentiment, SRL) run on the
port too, with their own limits. VGG-16 (the image chapter and serving)
is in ``tests/test_torch_vgg.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.tools import book

STEPS = 3


@pytest.fixture(autouse=True)
def surrogates(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    for mod in (pt.dataset.movielens, fluid.dataset.movielens):
        mod._CACHE = None
    yield
    for mod in (pt.dataset.movielens, fluid.dataset.movielens):
        mod._CACHE = None


def _fit_a_line():
    return book.build_fit_a_line, book.fit_a_line_feeds()


def _sentiment():
    vocab, feeds, _ = book.sentiment_feeds(n_train=256, n_test=64, max_len=48)
    return (lambda pkg: book.build_understand_sentiment(pkg, vocab, max_len=48, hid=32, emb=32,
                                                        lr=3e-3)), feeds


def _srl():
    sizes, feeds = book.srl_feeds(limit=256, max_len=16)
    return (lambda pkg: book.build_label_semantic_roles(pkg, *sizes, max_len=16, emb=16,
                                                        hid=32, depth=1, lr=8e-3)), feeds


def _recommender():
    sizes, feeds, _ = book.recommender_feeds(n_train=4 * book.REC_BATCH, n_test=0)
    return (lambda pkg: book.build_recommender_system(pkg, *sizes)), feeds


def _mnist():
    feeds, _ = book.mnist_feeds(epochs=1)
    return book.build_mnist_mlp, feeds


def _word2vec():
    return book.build_word2vec, book.word2vec_feeds(steps=STEPS)


def _machine_translation():
    # one layer of the example's two: the Transformer itself is held at depth
    # in tests/test_torch_transformer.py; this case holds the chapter on the
    # wmt16 loader, and the JAX compile of a second layer doubles its cost
    def build(pkg):
        return book.build_machine_translation(pkg, jtransformer if pkg is fluid else ttransformer,
                                              n_layers=1)
    return build, book.machine_translation_feeds(steps=STEPS)


CHAPTERS = {"fit_a_line": _fit_a_line, "understand_sentiment": _sentiment,
            "label_semantic_roles": _srl, "recommender_system": _recommender,
            "mnist_mlp": _mnist, "word2vec": _word2vec,
            "machine_translation": _machine_translation}


# Built, started and compiled once a module: the JAX compiles of a startup and
# a step cost seconds each, and two tests read the SRL and MNIST chapters.
@functools.lru_cache(maxsize=None)
def _chapter(name):
    """(the JAX package's chapter, the port's, the feeds: read once)."""
    build, feeds = CHAPTERS[name]()
    return build(fluid), build(pt), feeds


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


@functools.lru_cache(maxsize=None)
def _jax_exe(name):
    return fluid.Executor()


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX startup state of a chapter (numpy)."""
    ch = _chapter(name)[0]
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        _jax_exe(name).run(ch.startup)
    return {n: np.asarray(scope.find_var(n)) for n in _persistables(ch.main)}


def _jax_steps(name, feeds):
    """The JAX chapter's steps from its startup state, in a fresh scope."""
    ch, init, exe = _chapter(name)[0], _jax_init(name), _jax_exe(name)
    scope = fluid.Scope()
    for n, v in init.items():
        scope.set_var(n, jnp.asarray(v))
    with fluid.scope_guard(scope):
        outs = [[np.asarray(v) for v in exe.run(ch.main, feed=f, fetch_list=ch.fetch)]
                for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    return init, outs, final, scope, exe


def _port_steps(ch, feeds, init):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        outs = [exe.run(ch.main, feed=f, fetch_list=ch.fetch) for f in feeds]
    return outs, scope, exe


@pytest.mark.parametrize("name", sorted(CHAPTERS))
def test_chapter_trains_as_in_jax(name):
    """The chapter's program in both packages, then 3 steps from the JAX
    startup state: losses, the fetched metric and every state tensor."""
    jch, tch, feeds = _chapter(name)
    assert [b["ops"] for b in tch.main.to_dict()["blocks"]] == \
        [b["ops"] for b in jch.main.to_dict()["blocks"]]
    assert _persistables(tch.main) == _persistables(jch.main)
    feeds = feeds[:STEPS]
    init, jouts, jfinal, _, _ = _jax_steps(name, feeds)
    touts, scope, _ = _port_steps(tch, feeds, init)
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for j, t in zip(jouts, touts):
        if len(j) > 1:   # accuracy, a prediction or a Viterbi path
            if j[1].dtype.kind in "iu":
                np.testing.assert_array_equal(t[1], j[1])
            else:
                np.testing.assert_allclose(t[1], j[1], atol=1e-4, rtol=1e-4)
    for n, want in jfinal.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), want, atol=1e-4, err_msg=n)


def test_srl_viterbi_and_pruned_eval_match_jax():
    """The SRL chapter's evaluation as the example runs it: the Viterbi path
    fetched through ``use_prune`` (no update runs), equal to the JAX
    package's, and its token accuracy."""
    jch, tch, feeds = _chapter("label_semantic_roles")
    init, _, _, scope, exe = _jax_steps("label_semantic_roles", [])
    with fluid.scope_guard(scope):
        jpath, = exe.run(jch.main, feed=feeds[0], fetch_list=[jch.metric], use_prune=True)
    _, tscope, texe = _port_steps(tch, [], init)
    with pt.scope_guard(tscope):
        tpath, = texe.run(tch.main, feed=feeds[0], fetch_list=[tch.metric], use_prune=True)
    np.testing.assert_array_equal(tpath, np.asarray(jpath))
    assert tscope.find_var("crfw").numpy().tolist() == init["crfw"].tolist()
    acc = book.viterbi_accuracy(tpath, feeds[0])
    assert acc == book.viterbi_accuracy(np.asarray(jpath), feeds[0]) and 0 <= acc <= 1


def test_mnist_test_program_matches_jax():
    """The example's ``clone(for_test=True)``, taken before ``minimize``:
    its accuracy on the test rows after 3 training steps."""
    jch, tch, feeds = _chapter("mnist_mlp")
    _, test = book.mnist_feeds(epochs=0)
    init, _, _, scope, exe = _jax_steps("mnist_mlp", feeds[:STEPS])
    with fluid.scope_guard(scope):
        ja, = exe.run(jch.test, feed=test, fetch_list=[jch.metric])
    _, tscope, texe = _port_steps(tch, feeds[:STEPS], init)
    with pt.scope_guard(tscope):
        ta, = texe.run(tch.test, feed=test, fetch_list=[tch.metric])
    assert float(ta) == float(np.asarray(ja)) and float(ta) > 0.5


# -- the learn-asserts of tests/test_book_chapters.py, on the port -----------------------

def _train_port(ch, feeds, fetch=None):
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(ch.startup)
        outs = [exe.run(ch.main, feed=f, fetch_list=fetch or ch.fetch) for f in feeds]
    return outs, scope, exe


def test_fit_a_line_converges_on_the_port():
    build, feeds = _fit_a_line()
    ch = build(pt)
    outs, _, _ = _train_port(ch, feeds[:15 * len(feeds) // book.FIT_EPOCHS])
    first, last = float(outs[0][0].reshape(-1)[0]), float(outs[-1][0].reshape(-1)[0])
    assert last < first * 0.2, (first, last)


def test_understand_sentiment_learns_on_the_port():
    build, feeds = _sentiment()
    ch = build(pt)
    per_epoch = 256 // book.SENT_BATCH
    outs, _, _ = _train_port(ch, feeds[:per_epoch] * 8)
    accs = [float(o[1].reshape(-1)[0]) for o in outs]
    assert np.mean(accs[-4:]) > 0.85, accs[-4:]


def test_label_semantic_roles_learns_on_the_port():
    build, feeds = _srl()
    ch = build(pt)
    per_epoch = 256 // book.SRL_BATCH
    _, scope, exe = _train_port(ch, feeds[:per_epoch] * 10, fetch=[])
    with pt.scope_guard(scope):
        path, = exe.run(ch.main, feed=feeds[0], fetch_list=[ch.metric], use_prune=True)
    assert book.viterbi_accuracy(path, feeds[0]) > 0.8
