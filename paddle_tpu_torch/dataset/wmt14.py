"""WMT14 en->fr reader creators (reference python/paddle/dataset/wmt14.py:
train/test/get_dict -- NOTE get_dict defaults reverse=True there, returning
id->word dicts, unlike wmt16).

Shares dataset/wmt16.py's machinery with its OWN cache identity: a real
archive goes under data_home('wmt14')/wmt14.tar.gz (members wmt14/train,
wmt14/test, '|||'-separated pairs); otherwise the synthetic
permuted-reversal parallel corpus serves, with dicts coherent with the
reader ids in both cases.

The port's copy of ``paddle_tpu/dataset/wmt14.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

from . import wmt16 as _w

START, END, UNK = 0, 1, 2


def train(dict_size):
    return _w._creator("train", dict_size, dict_size, "en", dataset="wmt14")


def test(dict_size):
    return _w._creator("test", dict_size, dict_size, "en", dataset="wmt14")


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); id->word by default (the reference's
    wmt14 convention)."""
    return (_w.get_dict("en", dict_size, reverse, dataset="wmt14"),
            _w.get_dict("fr", dict_size, reverse, dataset="wmt14"))
