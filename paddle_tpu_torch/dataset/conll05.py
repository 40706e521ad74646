"""CoNLL-2005 SRL reader creators (reference python/paddle/dataset/conll05.py:1).

Surface parity: ``get_dict()`` -> (word_dict, verb_dict, label_dict);
``test()`` yields the 9-slot tuple the SRL chapter feeds:
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, labels)
where ctx_* are the predicate-context words broadcast over the sentence and
mark flags the predicate window.

Reads a cached ``test.wsj.words`` / ``test.wsj.props`` pair (the reference's
conll05st file names, optionally .gz) from the data home when present --
props are parsed from the bracketed-span column format into BIO labels, one
sample per predicate (reference conll05.py:87 corpus_reader semantics).
Otherwise falls back to a synthetic corpus whose role labels are a learnable
function of position relative to the predicate (B-A0 before, B-V at, B-A1
after, O elsewhere) so the CRF chapter genuinely converges.

The port's copy of ``paddle_tpu/dataset/conll05.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

_WORDS = 512
_VERBS = 64
_LABELS = ["O", "B-A0", "I-A0", "B-V", "B-A1", "I-A1"]
_N_TEST = 600


def _home():
    from . import data_home
    return data_home("conll05")


def _find_real():
    """(words_path, props_path) if the cached corpus exists, else None."""
    base = _home()
    for ext in ("", ".gz"):
        w = os.path.join(base, "test.wsj.words" + ext)
        p = os.path.join(base, "test.wsj.props" + ext)
        if os.path.exists(w) and os.path.exists(p):
            return w, p
    return None


def _open(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def _sentence_blocks(f):
    block = []
    for line in f:
        line = line.strip()
        if not line:
            if block:
                yield block
                block = []
            continue
        block.append(line.split())
    if block:
        yield block


def _spans_to_bio(col):
    """One props column of bracketed spans -> BIO labels.

    ``(A0*`` opens span A0, ``*)`` closes the open span, ``(V*)`` is a
    one-token span; tokens inside an open span continue it (I- prefix).
    """
    labels, open_tag = [], None
    for tok in col:
        tag = None
        if tok.startswith("("):
            tag = tok[1:].split("*")[0]
            labels.append("B-" + tag)
            open_tag = tag if not tok.endswith(")") else None
        elif open_tag is not None:
            labels.append("I-" + open_tag)
            if tok.endswith(")"):
                open_tag = None
        else:
            labels.append("O")
    return labels


def _real_corpus(words_path, props_path):
    """[(words, verb_pos, verb_lemma, bio_labels)] — one sample per predicate."""
    samples = []
    with _open(words_path) as wf, _open(props_path) as pf:
        for wblock, pblock in zip(_sentence_blocks(wf), _sentence_blocks(pf)):
            words = [row[0] for row in wblock]
            if not pblock:
                continue
            n_preds = len(pblock[0]) - 1
            lemmas = [row[0] for row in pblock]
            for k in range(n_preds):
                col = [row[1 + k] for row in pblock]
                bio = _spans_to_bio(col)
                vpos = next((i for i, l in enumerate(bio) if l in ("B-V",)), None)
                if vpos is None or len(bio) != len(words):
                    continue
                samples.append((words, vpos, lemmas[vpos], bio))
    return samples


def _synthetic_corpus():
    from . import _warn_synthetic
    _warn_synthetic("conll05st")
    rng = np.random.RandomState(7)
    sents = []
    for _ in range(_N_TEST):
        n = int(rng.randint(6, 18))
        words = rng.randint(0, _WORDS, n)
        vpos = int(rng.randint(1, n - 1))
        verb = int(rng.randint(0, _VERBS))
        labels = []
        for i in range(n):
            if i == vpos:
                labels.append("B-V")
            elif i == vpos - 1:
                labels.append("B-A0")
            elif i == vpos + 1:
                labels.append("B-A1")
            elif i == vpos + 2 and i < n:
                labels.append("I-A1")
            else:
                labels.append("O")
        sents.append((words.tolist(), vpos, verb, labels))
    return sents


def _dicts_from_real(samples):
    words, verbs, labels = {}, {}, {}
    for ws, vpos, lemma, bio in samples:
        for w in ws:
            words.setdefault(w, len(words))
        verbs.setdefault(lemma, len(verbs))
        for l in bio:
            labels.setdefault(l, len(labels))
    words.setdefault("<unk>", len(words))
    return words, verbs, labels


_real_cache = {}


def _cached_real_samples(paths):
    """Parse the cached corpus once per (paths, mtimes) -- get_dict() and
    test() share the parse instead of re-reading the gzip pair."""
    key = tuple(paths) + tuple(os.path.getmtime(p) for p in paths)
    if key not in _real_cache:
        _real_cache.clear()
        _real_cache[key] = _real_corpus(*paths)
    return _real_cache[key]


def get_dict():
    """(word_dict, verb_dict, label_dict) (reference conll05.py:205)."""
    real = _find_real()
    if real is not None:
        return _dicts_from_real(_cached_real_samples(real))
    word_dict = {f"w{i}": i for i in range(_WORDS)}
    word_dict["<unk>"] = _WORDS - 1
    verb_dict = {f"v{i}": i for i in range(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Reference exposes a pretrained emb path; none here (no downloads)."""
    return None


def test():
    """Reader over the 9 SRL slots (reference conll05.py:150 reader_creator
    semantics: ctx_* are predicate context words repeated sen_len times)."""
    word_dict, verb_dict, label_dict = get_dict()
    real = _find_real()
    unk = word_dict.get("<unk>", len(word_dict) - 1)

    if real is not None:
        corpus = [( [word_dict.get(w, unk) for w in ws], vpos,
                    verb_dict[lemma], bio )
                  for ws, vpos, lemma, bio in _cached_real_samples(real)]
    else:
        corpus = _synthetic_corpus()

    def reader():
        for words, vpos, verb, labels in corpus:
            n = len(words)

            def ctx(off):
                j = vpos + off
                w = words[j] if 0 <= j < n else unk
                return [w] * n

            mark = [1 if abs(i - vpos) <= 0 else 0 for i in range(n)]
            yield (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                   [verb] * n, mark, [label_dict[l] for l in labels])

    return reader
