"""MovieLens-1M recommender (reference: python/paddle/v2/dataset/
movielens.py).

Real path: the ml-1m.zip archive's movies.dat / users.dat /
ratings.dat members, with the reference's MovieInfo/UserInfo meta
(title word dict, category dict, age bucket table) and its seeded
random train/test split (reference movielens.py:100-187).
Records: (user_id, gender, age_bucket, job, movie_id, category_ids,
title_word_ids, rating).  Offline fallback: deterministic synthetic
records with the 1M-corpus vocab sizes.
"""

import re
import zipfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "age_table", "movie_categories", "max_job_id",
           "user_info", "movie_info", "MovieInfo", "UserInfo"]

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

MAX_USER = 6040
MAX_MOVIE = 3952
AGES = 7
JOBS = 21
CATEGORIES = 18
TITLE_VOCAB = 5174

AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    """Movie id, title-word ids and category ids (reference
    movielens.py:43-66)."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [_META["categories"][c] for c in self.categories],
                [_META["title_dict"][w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")


class UserInfo:
    """User id, gender, age bucket, job (reference movielens.py:69-89)."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = AGE_TABLE.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), "
                f"gender({'M' if self.is_male else 'F'}), "
                f"age({AGE_TABLE[self.age]}), job({self.job_id})>")


_META = None


def _load_meta():
    """Parse movies.dat/users.dat once per process; None when the
    archive is unavailable (synthetic mode)."""
    global _META
    if _META is not None:
        return _META
    path = common.maybe_download(URL, "movielens", MD5)
    if path is None:
        _META = False
        return False
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movie_info, title_words, categories = {}, set(), set()
    with zipfile.ZipFile(path) as pkg:
        names = {n.split("/")[-1]: n for n in pkg.namelist()}
        with pkg.open(names["movies.dat"]) as f:
            for line in f:
                line = line.decode("latin1").strip()
                if not line:
                    continue
                mid, title, cats = line.split("::")
                cats = cats.split("|")
                title = pattern.match(title).group(1).strip()
                movie_info[int(mid)] = MovieInfo(mid, cats, title)
                categories.update(cats)
                title_words.update(w.lower() for w in title.split())
        user_info = {}
        with pkg.open(names["users.dat"]) as f:
            for line in f:
                line = line.decode("latin1").strip()
                if not line:
                    continue
                uid, gender, age, job, _zip = line.split("::")
                user_info[int(uid)] = UserInfo(uid, gender, age, job)
    _META = {
        "path": path,
        "movie_info": movie_info,
        "user_info": user_info,
        "categories": {c: i for i, c in enumerate(sorted(categories))},
        "title_dict": {w: i for i, w in enumerate(sorted(title_words))},
    }
    return _META


def _real_reader(is_test, test_ratio=0.1, rand_seed=0):
    meta = _load_meta()

    def reader():
        rng = np.random.RandomState(rand_seed)
        with zipfile.ZipFile(meta["path"]) as pkg:
            names = {n.split("/")[-1]: n for n in pkg.namelist()}
            with pkg.open(names["ratings.dat"]) as f:
                for line in f:
                    line = line.decode("latin1").strip()
                    if not line:
                        continue
                    if (rng.rand() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.split("::")
                    usr = meta["user_info"][int(uid)]
                    mov = meta["movie_info"][int(mid)]
                    yield usr.value() + mov.value() + [float(rating)]

    return reader


def _synth(split, n):
    def reader():
        rng = common.synth_rng("movielens", split)
        for _ in range(n):
            uid = int(rng.randint(1, MAX_USER + 1))
            mid = int(rng.randint(1, MAX_MOVIE + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, AGES))
            job = int(rng.randint(0, JOBS))
            cats = rng.randint(0, CATEGORIES, rng.randint(1, 4)).tolist()
            title = rng.randint(0, TITLE_VOCAB, rng.randint(2, 8)).tolist()
            # rating correlated with (uid + mid) parity for learnability
            rating = float(((uid * 31 + mid * 17) % 5) + 1)
            yield (uid, gender, age, job, mid, cats, title, rating)

    return reader


def train():
    if _load_meta():
        return _real_reader(is_test=False)
    return _synth("train", 8192)


def test():
    if _load_meta():
        return _real_reader(is_test=True)
    return _synth("test", 1024)


def get_movie_title_dict():
    meta = _load_meta()
    if meta:
        return meta["title_dict"]
    return {f"t{i}": i for i in range(TITLE_VOCAB)}


def movie_categories():
    meta = _load_meta()
    if meta:
        return meta["categories"]
    return {f"c{i}": i for i in range(CATEGORIES)}


def max_user_id():
    meta = _load_meta()
    if meta:
        return max(meta["user_info"])
    return MAX_USER


def max_movie_id():
    meta = _load_meta()
    if meta:
        return max(meta["movie_info"])
    return MAX_MOVIE


def max_job_id():
    meta = _load_meta()
    if meta:
        return max(u.job_id for u in meta["user_info"].values())
    return JOBS - 1


def age_table():
    return list(AGE_TABLE)


def user_info():
    meta = _load_meta()
    return meta["user_info"] if meta else None


def movie_info():
    meta = _load_meta()
    return meta["movie_info"] if meta else None
