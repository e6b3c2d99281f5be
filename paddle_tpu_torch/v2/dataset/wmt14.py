"""WMT14 fr-en NMT (reference: python/paddle/v2/dataset/wmt14.py).

Real path: the preprocessed wmt14.tgz (src.dict / trg.dict members +
"src<TAB>trg" line files under train/ and test/), with the reference's
<s>/<e>/<unk> convention and the len>80 training filter (reference
wmt14.py:45-101).  Records: (src_ids, trg_ids_with_bos, trg_ids_next)
— the standard teacher-forcing triple.  Offline fallback: a learnable
deterministic "reverse + offset" synthetic translation task.
"""

import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "get_dict"]

URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/"
             "wmt_shrinked_data/wmt14.tgz")
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"

DICT_SIZE = 30000
START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID = 0   # <s>
END_ID = 1     # <e>
UNK_ID = 2     # <unk>


def _archive():
    return common.maybe_download(URL_TRAIN, "wmt14", MD5_TRAIN)


def _read_to_dict(tar_path, dict_size):
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode("utf-8", errors="replace").strip()] = i
        return out

    with tarfile.open(tar_path, mode="r") as f:
        src_name = [m.name for m in f if m.name.endswith("src.dict")]
        trg_name = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1
        src_dict = to_dict(f.extractfile(src_name[0]), dict_size)
        trg_dict = to_dict(f.extractfile(trg_name[0]), dict_size)
    return src_dict, trg_dict


def _real_reader(tar_path, file_name, dict_size, train_filter):
    def reader():
        src_dict, trg_dict = _read_to_dict(tar_path, dict_size)
        with tarfile.open(tar_path, mode="r") as f:
            names = [m.name for m in f
                     if m.isfile() and m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode(
                        "utf-8", errors="replace").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, UNK_ID)
                               for w in [START] + parts[0].split() + [END]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK_ID) for w in trg_words]
                    if train_filter and (len(src_ids) > 80 or
                                         len(trg_ids) > 80):
                        continue
                    trg_ids_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next

    return reader


def _synth(split, n, max_len=20):
    def reader():
        rng = common.synth_rng("wmt14", split)
        for _ in range(n):
            L = int(rng.randint(4, max_len))
            src = rng.randint(3, DICT_SIZE, L).astype(np.int64)
            # deterministic "translation": reverse + offset (learnable)
            trg = ((src[::-1] + 7) % (DICT_SIZE - 3) + 3).astype(np.int64)
            trg_in = np.concatenate([[START_ID], trg])
            trg_next = np.concatenate([trg, [END_ID]])
            yield (src.tolist(), trg_in.tolist(), trg_next.tolist())

    return reader


def train(dict_size=DICT_SIZE):
    tar_path = _archive()
    if tar_path is not None:
        return _real_reader(tar_path, "train/train", dict_size, True)
    return _synth("train", 4096)


def test(dict_size=DICT_SIZE):
    tar_path = _archive()
    if tar_path is not None:
        return _real_reader(tar_path, "test/test", dict_size, False)
    return _synth("test", 512)


def get_dict(dict_size=DICT_SIZE, reverse=False):
    """(src_dict, trg_dict), optionally id->word (reference
    wmt14.py:136-146)."""
    tar_path = _archive()
    if tar_path is not None:
        src_dict, trg_dict = _read_to_dict(tar_path, dict_size)
    else:
        src_dict = {f"s{i}": i for i in range(dict_size)}
        trg_dict = {f"t{i}": i for i in range(dict_size)}
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict
