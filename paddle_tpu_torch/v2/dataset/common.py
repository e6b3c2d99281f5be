"""The datasets' cache and the synthetic corpora's generator
(``paddle_tpu/v2/dataset/common.py``): ``DATA_HOME``, ``md5file``,
``download``, ``split``, ``cluster_files_reader``, ``convert`` and
``synth_rng``.

A dataset parses the real corpus when it is in the cache under
``DATA_HOME/<name>``, and otherwise serves a deterministic synthetic
corpus with the real one's record schema.  The port never downloads:
``download`` finds a cached file or raises, and ``maybe_download``
memoizes the miss.
"""

import hashlib
import os
import pickle
import sys
import zlib

import numpy as np

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))

__all__ = ["DATA_HOME", "md5file", "download", "maybe_download", "split",
           "cluster_files_reader", "convert", "cache_path", "has_cache",
           "synth_rng"]


def cache_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def has_cache(*parts):
    return os.path.exists(cache_path(*parts))


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


# (filename, md5sum) pairs already MD5-checked in this process, and the
# outcome of maybe_download by (DATA_HOME, url)
_VERIFIED: set = set()
_DOWNLOAD_MEMO: dict = {}


def download(url: str, module_name: str, md5sum: str,
             retry_limit: int = 3) -> str:
    """The cached path of ``url``: ``DATA_HOME/<module_name>/<basename>``.
    A cached file whose MD5 differs from ``md5sum`` is used with a note
    (a user-provided corpus or a fixture) and never overwritten.  A
    missing file raises ``RuntimeError``: the port works offline, and the
    caller falls back to its synthetic corpus."""
    filename = os.path.join(DATA_HOME, module_name, url.split("/")[-1])
    if not os.path.exists(filename):
        raise RuntimeError(
            f"{url} is not cached (the port downloads nothing); put the "
            f"file at {filename} to use the real corpus")
    if md5sum is None or (filename, md5sum) in _VERIFIED:
        return filename
    if md5file(filename) == md5sum:
        _VERIFIED.add((filename, md5sum))
    else:
        print(f"paddle_tpu_torch.dataset: using cached {filename} with a "
              f"non-reference MD5 (a user-provided corpus or a fixture)",
              file=sys.stderr)
    return filename


def maybe_download(url: str, module_name: str, md5sum: str):
    """``download``, or None where it raises: where a dataset picks the
    real corpus or the synthetic one.  Memoized by (DATA_HOME, url) for
    the process."""
    memo_key = (DATA_HOME, url)
    if memo_key in _DOWNLOAD_MEMO:
        return _DOWNLOAD_MEMO[memo_key]
    try:
        path = download(url, module_name, md5sum)
    except RuntimeError:
        path = None
    _DOWNLOAD_MEMO[memo_key] = path
    return path


def split(reader, line_count: int, suffix: str = "%05d.pickle",
          dumper=None):
    """Split a reader's records into pickled chunk files of
    ``line_count`` records (reference: common.py:105-141)."""
    if not callable(reader):
        raise TypeError("reader should be callable")
    if "%" not in suffix:
        raise ValueError("suffix should contain %d")
    dumper = dumper or (lambda obj, f: pickle.dump(obj, f, protocol=2))
    lines, index = [], 0
    for rec in reader():
        lines.append(rec)
        if len(lines) == line_count:
            with open(suffix % index, "wb") as f:
                dumper(lines, f)
            lines, index = [], index + 1
    if lines:
        with open(suffix % index, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=None):
    """Round-robin chunk-file reader for one trainer of a cluster job
    (reference: common.py:144-172)."""
    loader = loader or pickle.load

    def reader():
        import glob

        file_list = sorted(glob.glob(files_pattern))
        my_files = [f for i, f in enumerate(file_list)
                    if i % trainer_count == trainer_id]
        for fn in my_files:
            with open(fn, "rb") as f:
                for rec in loader(f):
                    yield rec

    return reader


def convert(output_path: str, reader, line_count: int, name_prefix: str):
    """A reader's records as pickled chunk files of ``line_count``
    records under ``output_path``."""
    split(reader, line_count,
          suffix=os.path.join(output_path, name_prefix + "-%05d.pickle"))


def synth_rng(name: str, split_name: str):
    # crc32, not hash(): Python randomizes str hashes per process, and
    # the synthetic corpora must be identical across processes/runs
    return np.random.RandomState(
        zlib.crc32(f"{name}/{split_name}".encode()))
