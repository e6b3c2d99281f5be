"""CoNLL-05 semantic role labeling (reference: python/paddle/v2/dataset/
conll05.py).

Real path: the conll05st-tests tarball's gzipped words/props members,
with the reference's bracket-label expansion (``(A0*`` → B-A0, ``*`` →
I-A0/O, ``*)`` closes — conll05.py:53-131) and its 9-slot record
assembly around the B-V predicate (conll05.py:125-177).  Dictionaries
come from the cached wordDict/verbDict/targetDict files when present,
else are built from the corpus itself (documented offline deviation).
Records: (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids,
mark, label_ids) — all sequences of equal length.
"""

import gzip
import itertools
import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["get_dict", "get_embedding", "test", "train", "corpus_reader"]

DATA_URL = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/wordDict.txt")
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/verbDict.txt")
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
               "srl_dict_and_embedding/targetDict.txt")
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"
EMB_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
           "srl_dict_and_embedding/emb")
EMB_MD5 = "bf436eb0faa1f6f9103017f8be57cdb7"

WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"

UNK_IDX = 0

WORD_VOCAB = 44068
PRED_VOCAB = 3162
LABEL_COUNT = 67


def load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def corpus_reader(data_path, words_name=WORDS_NAME, props_name=PROPS_NAME):
    """Yield (sentence words, predicate, label sequence) triples from
    the words/props pair (reference conll05.py:53-131)."""

    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences = []
                labels = []
                one_seg = []
                for word, label in itertools.zip_longest(
                        words_file, props_file, fillvalue=b""):
                    word = word.decode("utf-8", errors="replace").strip()
                    label = label.decode(
                        "utf-8", errors="replace").strip().split()
                    if len(label) == 0:  # end of sentence
                        for i in range(len(one_seg[0]) if one_seg else 0):
                            labels.append([x[i] for x in one_seg])
                        if len(labels) >= 1:
                            verb_list = [x for x in labels[0] if x != "-"]
                            for i, lbl in enumerate(labels[1:]):
                                cur_tag, in_bracket = "O", False
                                lbl_seq = []
                                for l in lbl:
                                    if l == "*" and not in_bracket:
                                        lbl_seq.append("O")
                                    elif l == "*" and in_bracket:
                                        lbl_seq.append("I-" + cur_tag)
                                    elif l == "*)":
                                        lbl_seq.append("I-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l and ")" in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l and ")" not in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = True
                                    else:
                                        raise RuntimeError(
                                            f"Unexpected label: {l}")
                                yield sentences, verb_list[i], lbl_seq
                        sentences, labels, one_seg = [], [], []
                    else:
                        sentences.append(word)
                        one_seg.append(label)

    return reader


def _reader_creator(corpus, word_dict, predicate_dict, label_dict):
    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = "bos"
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = "bos"
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = "eos"
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = "eos"

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctxs = [[word_dict.get(c, UNK_IDX)] * sen_len
                    for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            pred_idx = [predicate_dict.get(predicate, 0)] * sen_len
            label_idx = [label_dict.get(w, 0) for w in labels]
            yield (word_idx, *ctxs, pred_idx, mark, label_idx)

    return reader


def _corpus_dicts(corpus):
    """Offline deviation: when the pre-trained dict files are absent,
    derive the three dictionaries from the corpus itself."""
    words, verbs, labels = set(), set(), set()
    for sentence, predicate, lbl_seq in corpus():
        words.update(sentence)
        verbs.add(predicate)
        labels.update(lbl_seq)
    return ({w: i for i, w in enumerate(sorted(words))},
            {v: i for i, v in enumerate(sorted(verbs))},
            {l: i for i, l in enumerate(sorted(labels))})


def get_dict():
    """(word, verb, label) dicts: cached reference dict files, else
    corpus-derived, else synthetic stand-ins."""
    paths = [common.maybe_download(u, "conll05st", m) for u, m in
             ((WORDDICT_URL, WORDDICT_MD5), (VERBDICT_URL, VERBDICT_MD5),
              (TRGDICT_URL, TRGDICT_MD5))]
    if all(p is not None for p in paths):
        return tuple(load_dict(p) for p in paths)
    data = common.maybe_download(DATA_URL, "conll05st", DATA_MD5)
    if data is not None:
        return _corpus_dicts(corpus_reader(data))
    word = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb = {f"v{i}": i for i in range(PRED_VOCAB)}
    label = {f"l{i}": i for i in range(LABEL_COUNT)}
    return word, verb, label


def get_embedding():
    path = common.maybe_download(EMB_URL, "conll05st", EMB_MD5)
    if path is not None:
        return path
    rng = common.synth_rng("conll05", "emb")
    return rng.randn(WORD_VOCAB, 32).astype(np.float32)


def _synth(split, n):
    def reader():
        rng = common.synth_rng("conll05", split)
        for _ in range(n):
            L = int(rng.randint(5, 30))
            words = rng.randint(0, WORD_VOCAB, L)
            ctxs = [np.roll(words, s) for s in (2, 1, 0, -1, -2)]
            verb = np.full(L, rng.randint(0, PRED_VOCAB))
            mark = (rng.rand(L) < 0.2).astype(np.int64)
            labels = (words * 7 + mark * 13) % LABEL_COUNT
            yield tuple(
                a.astype(np.int64).tolist()
                for a in (words, *ctxs, verb, mark, labels))

    return reader


def test():
    """The public CoNLL-05 test set (the train set is not free; the
    reference trains on this too — conll05.py:205-214)."""
    data = common.maybe_download(DATA_URL, "conll05st", DATA_MD5)
    if data is not None:
        word_dict, verb_dict, label_dict = get_dict()
        return _reader_creator(corpus_reader(data), word_dict, verb_dict,
                               label_dict)
    return _synth("test", 512)


def train():
    data = common.maybe_download(DATA_URL, "conll05st", DATA_MD5)
    if data is not None:
        return test()
    return _synth("train", 4096)
