"""Reader creators (``paddle_tpu/v2/reader/creator.py``): ``np_array``,
``text_file``, ``cloud_reader`` and ``recordio``.  The native runtime
(the master's task stream, the RecordIO reader) comes with ROADMAP
Queue 1 item 3 step 6; until then ``recordio`` raises, and so does
``cloud_reader`` where a master address is configured."""

from __future__ import annotations

import numpy as np

_NATIVE = ("the native runtime of paddle_tpu_torch comes with ROADMAP "
           "Queue 1 item 3 step 6 (distributed/ and the C++ runtime)")


def np_array(x):
    def reader():
        for e in np.asarray(x):
            yield e

    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def cloud_reader(paths, etcd_endpoints=None, timeout_sec=5, buf_size=64):
    """The files' lines, read directly where no master address
    (``PADDLE_MASTER_ADDR``) is configured; the master's task stream
    raises until the native runtime is ported."""
    import os

    if os.environ.get("PADDLE_MASTER_ADDR"):
        raise NotImplementedError(f"cloud_reader from a master: {_NATIVE}")

    def reader():
        for p in paths:
            with open(p, "rb") as f:
                for line in f:
                    yield line.rstrip(b"\n")

    return reader


def recordio(paths, buf_size=100):
    """Pickled samples out of RecordIO shard files: the native RecordIO
    reader is not ported yet, so this raises."""
    raise NotImplementedError(f"recordio: {_NATIVE}")
