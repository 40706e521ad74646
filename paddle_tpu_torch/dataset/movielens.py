"""MovieLens ml-1m reader creators (reference python/paddle/dataset/
movielens.py:36-210).

Surface parity: train()/test() reader creators yielding
[uid, gender_id, age_id, job_id, mov_id, category_ids, title_ids, [rating]]
(usr.value() + mov.value() + [[rating]]), plus the id-space helpers
(max_user_id/max_movie_id/max_job_id, age_table, movie_categories,
get_movie_title_dict). Reads a cached ml-1m.zip when present; else a
synthetic corpus with real latent structure (ratings = user x movie latent
dot products) so the recommender chapter genuinely learns.

The port's copy of ``paddle_tpu/dataset/movielens.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import os
import zipfile

import numpy as np

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 400
_N_MOVIES = 300
_N_JOBS = 21
_N_CATEGORIES = 18
_TITLE_WORDS = 512
_TITLE_LEN = 4
_LATENT = 6
_N_RATINGS = 24000


def _home():
    from . import data_home
    return data_home("movielens")


def _find_real():
    p = os.path.join(_home(), "ml-1m.zip")
    return p if os.path.exists(p) else None


_CACHE = None


def _real_corpus(zf_path):
    users, movies, ratings = {}, {}, []
    with zipfile.ZipFile(zf_path) as z:
        with z.open("ml-1m/users.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, gender, age, job, _ = line.strip().split("::")
                users[int(uid)] = [int(uid), 0 if gender == "M" else 1,
                                   age_table.index(int(age)), int(job)]
        cats, titles = {}, {"<unk>": 0}
        with z.open("ml-1m/movies.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                mid, title, cat = line.strip().split("::")
                cat_ids = []
                for c in cat.split("|"):
                    cats.setdefault(c, len(cats))
                    cat_ids.append(cats[c])
                tw = []
                for w in title.lower().split():
                    titles.setdefault(w, len(titles))
                    tw.append(titles[w])
                movies[int(mid)] = [int(mid), cat_ids, tw]
        with z.open("ml-1m/ratings.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, mid, r, _ = line.strip().split("::")
                if int(mid) in movies and int(uid) in users:
                    ratings.append((int(uid), int(mid),
                                    float(r) * 2 - 5.0))
    return users, movies, ratings, titles


def _synthetic_corpus():
    from . import _warn_synthetic
    _warn_synthetic("movielens")
    rng = np.random.RandomState(11)
    u_lat = rng.randn(_N_USERS + 1, _LATENT)
    m_lat = rng.randn(_N_MOVIES + 1, _LATENT)
    users = {u: [u, int(rng.randint(0, 2)), int(rng.randint(0, 7)),
                 int(rng.randint(0, _N_JOBS))]
             for u in range(1, _N_USERS + 1)}
    movies = {m: [m, sorted(set(rng.randint(0, _N_CATEGORIES,
                                            rng.randint(1, 4)).tolist())),
                  rng.randint(1, _TITLE_WORDS, _TITLE_LEN).tolist()]
              for m in range(1, _N_MOVIES + 1)}
    ratings = []
    for _ in range(_N_RATINGS):
        u = int(rng.randint(1, _N_USERS + 1))
        m = int(rng.randint(1, _N_MOVIES + 1))
        score = float(np.tanh(u_lat[u] @ m_lat[m] / _LATENT) * 5)
        ratings.append((u, m, score + rng.randn() * 0.1))
    return users, movies, ratings, {f"w{i}": i for i in range(_TITLE_WORDS)}


def _corpus():
    global _CACHE
    if _CACHE is None:
        real = _find_real()
        _CACHE = (_real_corpus(real) if real else _synthetic_corpus())
    return _CACHE


def _reader(is_test, test_ratio=0.1, rand_seed=0):
    users, movies, ratings, _ = _corpus()
    rng = np.random.RandomState(rand_seed)
    for uid, mid, r in ratings:
        if (rng.random_sample() < test_ratio) == is_test:
            usr = users[uid]
            mov = movies[mid]
            yield usr + [mov[0], mov[1], mov[2]] + [[r]]


def train(**kw):
    return lambda: _reader(False, **kw)


def test(**kw):
    return lambda: _reader(True, **kw)


def max_user_id():
    return max(_corpus()[0])


def max_movie_id():
    return max(_corpus()[1])


def max_job_id():
    return max(u[3] for u in _corpus()[0].values())


def movie_categories():
    return max(c for m in _corpus()[1].values() for c in m[1]) + 1


def get_movie_title_dict():
    """{title word: id} -- the real dict when ml-1m is cached, the
    synthetic vocab otherwise."""
    return dict(_corpus()[3])


def user_info():
    return _corpus()[0]


def movie_info():
    return _corpus()[1]
