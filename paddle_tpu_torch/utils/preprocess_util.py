"""Dataset preprocessing scaffolding (reference:
python/paddle/utils/preprocess_util.py — list images per label dir,
split train/test, persist batches).  Batches persist as ``.npz``
(arrays ``data``, ``labels``) instead of cPickle blobs."""

import os

import numpy as np

__all__ = ["list_images", "get_label_set_from_dir", "save_batch",
           "load_batch", "DatasetCreater"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def list_images(path):
    return sorted(
        f for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in _IMG_EXTS)


def get_label_set_from_dir(path):
    """{label_name: label_id} from the sub-directory names (the v1
    image-classification layout: one directory per class)."""
    dirs = sorted(d for d in os.listdir(path)
                  if os.path.isdir(os.path.join(path, d)))
    return {d: i for i, d in enumerate(dirs)}


def save_batch(path, data, labels):
    np.savez_compressed(path, data=np.asarray(data),
                        labels=np.asarray(labels))


def load_batch(path):
    with np.load(path) as d:
        return d["data"], d["labels"]


class DatasetCreater:
    """Walk a per-class image tree, split train/test, and emit batch
    files + meta (reference preprocess_util.DatasetCreater)."""

    def __init__(self, data_path, batch_size=128, test_ratio=0.1):
        self.data_path = data_path
        self.batch_size = batch_size
        self.test_ratio = test_ratio
        self.label_set = get_label_set_from_dir(data_path)

    def sample_list(self, rng=None):
        """→ [(img_path, label_id)] shuffled."""
        rng = rng or np.random.RandomState(0)
        samples = []
        for label, idx in self.label_set.items():
            d = os.path.join(self.data_path, label)
            samples.extend((os.path.join(d, f), idx)
                           for f in list_images(d))
        rng.shuffle(samples)
        return samples

    def create_dataset(self, out_dir, loader):
        """``loader(path) -> np.ndarray`` per image; writes
        train_batch_N.npz / test_batch_N.npz + labels.txt, returns the
        (train, test) batch-file lists."""
        os.makedirs(out_dir, exist_ok=True)
        samples = self.sample_list()
        n_test = int(len(samples) * self.test_ratio)
        splits = {"test": samples[:n_test], "train": samples[n_test:]}
        out = {}
        for split, rows in splits.items():
            files = []
            for b in range(0, len(rows), self.batch_size):
                chunk = rows[b:b + self.batch_size]
                arr = np.stack([loader(p) for p, _ in chunk])
                labs = np.asarray([l for _, l in chunk], np.int64)
                fn = os.path.join(out_dir,
                                  f"{split}_batch_{b // self.batch_size}.npz")
                save_batch(fn, arr, labs)
                files.append(fn)
            out[split] = files
        with open(os.path.join(out_dir, "labels.txt"), "w") as f:
            for label, idx in sorted(self.label_set.items(),
                                     key=lambda kv: kv[1]):
                f.write(f"{idx} {label}\n")
        return out["train"], out["test"]
