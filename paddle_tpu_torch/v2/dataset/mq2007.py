"""MQ2007 LETOR learning-to-rank (reference:
python/paddle/v2/dataset/mq2007.py).

Real path: LETOR plain-text files (``<rel> qid:<id> 1:<v> 2:<v> ...``)
parsed into per-query groups (reference mq2007.py:268-321).  The
official archive is a .rar; since rar extraction is not available,
drop the extracted fold files (e.g. ``Fold1/train.txt``) anywhere
under ``DATA_HOME/MQ2007/`` and they are picked up by split name.

Record formats match the reference's three modes:
  - ``pointwise``: (feature float32[46], relevance float)
  - ``pairwise``: (query_left float32[46], query_right float32[46]) with
    left more relevant than right
  - ``listwise``: (label list, feature-list) per query

Offline fallback: a deterministic synthetic corpus with query-grouped
records (same schema, 46 LETOR features, graded relevance 0-2).
"""

import glob
import os

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "load_from_text"]

URL = ("http://www.bigdatalab.ac.cn/benchmark/upload/download_source/"
       "7b6dbbe2-842c-11e4-a536-bcaec51b9163_MQ2007.rar")
MD5 = "7be1640ae95c6408dab0ae7207bdc706"

FEATURE_DIM = 46


def load_from_text(filepath, fill_missing=-1.0):
    """Parse a LETOR text file into [(qid, [(rel, feature[46])])]
    groups, preserving query order (reference mq2007.py:268-293)."""
    groups = {}
    order = []
    with open(filepath, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(parts[0])
            qid = parts[1].split(":")[1]
            feats = np.full(FEATURE_DIM, fill_missing, np.float32)
            for tok in parts[2:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                i = int(k) - 1
                if 0 <= i < FEATURE_DIM:
                    feats[i] = float(v)
            if qid not in groups:
                groups[qid] = []
                order.append(qid)
            groups[qid].append((rel, feats))
    return [(qid, groups[qid]) for qid in order]


def _find_split_file(split):
    root = common.cache_path("MQ2007")
    if not os.path.isdir(root):
        return None
    hits = sorted(glob.glob(os.path.join(root, "**", f"{split}.txt"),
                            recursive=True))
    return hits[0] if hits else None


def _gen(queries, fmt):
    def pointwise():
        for _, docs in queries:
            for rel, x in docs:
                yield (x, float(rel))

    def pairwise():
        for _, docs in queries:
            for i, (ri, xi) in enumerate(docs):
                for rj, xj in docs[i + 1:]:
                    if ri > rj:
                        yield (xi, xj)
                    elif rj > ri:
                        yield (xj, xi)

    def listwise():
        for _, docs in queries:
            yield ([float(r) for r, _ in docs], [x for _, x in docs])

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[fmt]


def _synth_queries(split, n_queries, docs_per_query):
    rng = common.synth_rng("mq2007", split)
    out = []
    for qi in range(n_queries):
        qvec = rng.randn(FEATURE_DIM).astype(np.float32)
        docs = []
        for _ in range(docs_per_query):
            x = (qvec + rng.randn(FEATURE_DIM)).astype(np.float32)
            # relevance correlates with projection on the query direction
            score = float(x @ qvec) / FEATURE_DIM
            rel = 2 if score > 0.5 else (1 if score > 0.0 else 0)
            docs.append((rel, x))
        out.append((str(qi), docs))
    return out


def _reader(split, fmt, n_queries, docs_per_query):
    path = _find_split_file(split)
    if path is not None:
        return _gen(load_from_text(path), fmt)
    return _gen(_synth_queries(split, n_queries, docs_per_query), fmt)


def train(format="pairwise"):
    return _reader("train", format, 200, 8)


def test(format="pairwise"):
    return _reader("test", format, 40, 8)
