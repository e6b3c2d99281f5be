"""IMDB sentiment (reference: python/paddle/v2/dataset/imdb.py).

Real path: downloads/caches the aclImdb_v1 tarball, streams member
files sequentially (same tarfile.next() access pattern as the
reference imdb.py:37-57), ad-hoc tokenizes (punctuation stripped,
lowercased), builds the corpus word dict with a frequency cutoff, and
yields interleaved pos/neg records.  Records: (word-id sequence,
label in {0,1}).

Offline fallback: a deterministic synthetic corpus with the same
schema and the era's imdb.pkl vocab size.
"""

import collections
import re
import string
import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["build_dict", "word_dict", "train", "test"]

URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

_VOCAB = 5149  # reference vocab size for the era's imdb.pkl
_PUNCT = str.maketrans("", "", string.punctuation)


def _archive():
    return common.maybe_download(URL, "imdb", MD5)


def tokenize(pattern, tar_path=None):
    """Sequentially stream tar members matching ``pattern``; yield each
    file as a token list (reference imdb.py:37-57 — tarfile.next(), not
    random-access extractfile)."""
    tar_path = tar_path or _archive()
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if tf.isfile() and bool(pattern.match(tf.name)):
                data = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="replace")
                yield (data.rstrip("\n\r").translate(_PUNCT).lower()
                       .split())
            tf = tarf.next()


def build_dict(pattern, cutoff, tar_path=None):
    """Word -> zero-based id, most-frequent-first, '<unk>' last
    (reference imdb.py:60-76)."""
    word_freq = collections.defaultdict(int)
    for doc in tokenize(pattern, tar_path):
        for word in doc:
            word_freq[word] += 1
    items = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(items, key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(dictionary)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(pos_pattern, neg_pattern, word_idx, tar_path):
    UNK = word_idx["<unk>"]

    def reader():
        pos = tokenize(pos_pattern, tar_path)
        neg = tokenize(neg_pattern, tar_path)
        # interleave pos/neg so downstream minibatches are balanced
        # (the reference uses two loader threads for the same effect)
        for p in pos:
            yield [word_idx.get(w, UNK) for w in p], 0
            n = next(neg, None)
            if n is not None:
                yield [word_idx.get(w, UNK) for w in n], 1
        for n in neg:
            yield [word_idx.get(w, UNK) for w in n], 1

    return reader


_DICT_CACHE: dict = {}


def word_dict(cutoff=150):
    """Corpus word dict (real archive) or the synthetic stand-in.
    Cached per (archive, cutoff): building it streams the whole
    tarball twice, which must not be re-paid by every reader."""
    tar_path = _archive()
    key = (tar_path, cutoff)
    if key in _DICT_CACHE:
        return _DICT_CACHE[key]
    if tar_path is not None:
        d = build_dict(
            re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
            cutoff, tar_path)
    else:
        d = {f"w{i}": i for i in range(_VOCAB - 1)}
        d["<unk>"] = _VOCAB - 1
    _DICT_CACHE[key] = d
    return d


def _synth(split, n, seq_range=(20, 100)):
    def reader():
        rng = common.synth_rng("imdb", split)
        # two "topic" distributions make the task learnable
        pos = rng.permutation(_VOCAB)
        for _ in range(n):
            y = int(rng.randint(0, 2))
            ln = int(rng.randint(*seq_range))
            base = pos[: _VOCAB // 2] if y else pos[_VOCAB // 2:]
            seq = base[rng.randint(0, base.shape[0], ln)]
            yield (seq.astype(np.int64).tolist(), y)

    return reader


def _split_reader(split, word_idx, n_synth):
    tar_path = _archive()
    if tar_path is None:
        return _synth(split, n_synth)
    if word_idx is None:
        word_idx = word_dict()
    return _real_reader(
        re.compile(rf"aclImdb/{split}/pos/.*\.txt$"),
        re.compile(rf"aclImdb/{split}/neg/.*\.txt$"), word_idx, tar_path)


def train(word_idx=None):
    return _split_reader("train", word_idx, 4096)


def test(word_idx=None):
    return _split_reader("test", word_idx, 512)
