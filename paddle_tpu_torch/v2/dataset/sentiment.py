"""Movie-review sentiment (reference: python/paddle/v2/dataset/
sentiment.py — the NLTK movie_reviews corpus).

Real path: an NLTK-layout corpus at
``DATA_HOME/sentiment/movie_reviews/{pos,neg}/*.txt`` (the directory
``nltk.download('movie_reviews', download_dir=DATA_HOME)`` produces, or
the unzipped corpus dropped there by hand).  Word dict is
frequency-sorted over the whole corpus (reference sentiment.py:54-71);
records interleave neg/pos (label 0 = file from 'neg', 1 = 'pos' —
reference's ``0 if 'neg' in file else 1``) and split 1600/400.

Offline fallback: delegates to the imdb synthetic corpus (same
record schema).
"""

import glob
import os
import re

from paddle_tpu_torch.v2.dataset import common, imdb

__all__ = ["get_word_dict", "train", "test"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

_WORD_RE = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9']")


def _corpus_dir():
    for cand in (common.cache_path("sentiment", "movie_reviews"),
                 common.cache_path("sentiment", "corpora", "movie_reviews"),
                 common.cache_path("corpora", "movie_reviews"),
                 common.cache_path("movie_reviews")):
        if os.path.isdir(os.path.join(cand, "pos")) and \
                os.path.isdir(os.path.join(cand, "neg")):
            return cand
    return None


def _words(path):
    with open(path, encoding="utf-8", errors="replace") as f:
        return _WORD_RE.findall(f.read().lower())


def _files(corpus):
    neg = sorted(glob.glob(os.path.join(corpus, "neg", "*.txt")))
    pos = sorted(glob.glob(os.path.join(corpus, "pos", "*.txt")))
    # interleave neg/pos for balanced minibatches (reference sort_files)
    out = []
    for n, p in zip(neg, pos):
        out += [n, p]
    return out


_CACHE = {}


def _tokenized(corpus):
    """One pass over the corpus: [(path tokens, label)] — both the word
    dict and the record stream derive from this."""
    if corpus in _CACHE:
        return _CACHE[corpus]
    toks = []
    for path in _files(corpus):
        label = 0 if os.sep + "neg" + os.sep in path else 1
        toks.append((_words(path), label))
    _CACHE[corpus] = toks
    return toks


def get_word_dict():
    """[(word, id)] sorted by corpus frequency (reference contract
    returns a list of pairs, not a dict)."""
    corpus = _corpus_dir()
    if corpus is None:
        return sorted(imdb.word_dict().items(), key=lambda x: x[1])
    freq = {}
    for words, _ in _tokenized(corpus):
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    ranked = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    return [(w, i) for i, (w, _) in enumerate(ranked)]


def _load_data():
    corpus = _corpus_dir()
    word_ids = dict(get_word_dict())
    return [([word_ids[w] for w in words], label)
            for words, label in _tokenized(corpus)]


def _real(lo, hi):
    def reader():
        for rec in _load_data()[lo:hi]:
            yield rec

    return reader


def train():
    if _corpus_dir() is not None:
        return _real(0, NUM_TRAINING_INSTANCES)
    return imdb.train()


def test():
    if _corpus_dir() is not None:
        return _real(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES)
    return imdb.test()
