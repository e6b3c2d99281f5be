"""PTB n-gram / sequence LM data (reference:
python/paddle/v2/dataset/imikolov.py).

Real path: the simple-examples tarball's ptb.train.txt / ptb.valid.txt
members, with the corpus-built word dict (frequency-cut, '<s>'/'<e>'
counted per line, '<unk>' last — reference imikolov.py:36-74).
Records: NGRAM mode yields word-id n-tuples; SEQ mode yields
(src_seq, trg_seq) shifted pairs.  Offline fallback: deterministic
markov-ish synthetic stream with the same schema.
"""

import collections
import tarfile

from paddle_tpu_torch.v2.dataset import common

__all__ = ["build_dict", "train", "test", "DataType"]

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"

_TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
_TEST_MEMBER = "./simple-examples/data/ptb.valid.txt"

_VOCAB = 2074


class DataType:
    NGRAM = 1
    SEQ = 2


def _archive():
    return common.maybe_download(URL, "imikolov", MD5)


def word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="replace")
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def _find_member(tf, name):
    # tolerate both "./simple-examples/..." and "simple-examples/..."
    for cand in (name, name[2:] if name.startswith("./") else "./" + name):
        try:
            return tf.extractfile(cand)
        except KeyError:
            continue
    raise KeyError(name)


def build_dict(min_word_freq=50):
    tar_path = _archive()
    if tar_path is None:
        return {f"w{i}": i for i in range(_VOCAB)}
    with tarfile.open(tar_path) as tf:
        trainf = _find_member(tf, _TRAIN_MEMBER)
        testf = _find_member(tf, _TEST_MEMBER)
        word_freq = word_count(testf, word_count(trainf))
        word_freq.pop("<unk>", None)  # re-added as the last index
        items = [x for x in word_freq.items() if x[1] > min_word_freq]
        items.sort(key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(items)}
        word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(member, word_idx, n, data_type):
    tar_path = _archive()

    def reader():
        with tarfile.open(tar_path) as tf:
            f = _find_member(tf, member)
            UNK = word_idx["<unk>"]
            for line in f:
                line = line.decode("utf-8", errors="replace")
                if DataType.NGRAM == data_type:
                    assert n > -1, "Invalid gram length"
                    toks = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(toks) >= n:
                        ids = [word_idx.get(w, UNK) for w in toks]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif DataType.SEQ == data_type:
                    toks = line.strip().split()
                    ids = [word_idx.get(w, UNK) for w in toks]
                    src_seq = [word_idx["<s>"]] + ids
                    trg_seq = ids + [word_idx["<e>"]]
                    if n > 0 and len(src_seq) > n:
                        continue
                    yield src_seq, trg_seq
                else:
                    raise AssertionError("Unknown data type")

    return reader


def _synth(split, n_recs, gram_n, data_type=1):
    def reader():
        rng = common.synth_rng("imikolov", split)
        # markov-ish stream: next = (3 * cur + noise) % V
        cur = int(rng.randint(0, _VOCAB))
        for _ in range(n_recs):
            window = []
            for _ in range(max(gram_n, 2)):
                window.append(cur)
                cur = int((3 * cur + rng.randint(0, 7)) % _VOCAB)
            if data_type == DataType.NGRAM:
                yield tuple(window[:gram_n])
            else:
                yield window, window[1:] + [0]

    return reader


def _reader(member, split, word_idx, n, data_type, n_synth):
    if n is None:
        # the reference API has no default for n; keep the historical
        # n=5 window for NGRAM, but never silently length-filter SEQ
        # mode (n>0 there means "drop sentences longer than n")
        n = 5 if data_type == DataType.NGRAM else 0
    if _archive() is None or word_idx is None or not isinstance(
            word_idx, dict) or "<unk>" not in word_idx:
        return _synth(split, n_synth, n if n > 0 else 5, data_type)
    return _real_reader(member, word_idx, n, data_type)


def train(word_idx=None, n=None, data_type=DataType.NGRAM):
    return _reader(_TRAIN_MEMBER, "train", word_idx, n, data_type, 8192)


def test(word_idx=None, n=None, data_type=DataType.NGRAM):
    return _reader(_TEST_MEMBER, "test", word_idx, n, data_type, 1024)
