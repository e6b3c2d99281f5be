"""Oxford 102 Flowers (reference: python/paddle/v2/dataset/flowers.py).

Real path: the official 102flowers.tgz + imagelabels.mat + setid.mat
triple; split flags follow the reference's deliberate swap (train =
'tstid', the larger split — flowers.py:50-55), labels are 1-indexed in
the .mat and shifted to 0-based.  The default mapper decodes the JPEG
with PIL, resizes the short side to 256, center-crops 224 and scales
to [0,1] CHW (the reference's simple_transform pipeline, flattened).
Records: (float32[3*224*224] in [0,1], label in [0,102)).

Offline fallback: class-conditional synthetic images with the same
tuple contract at 3*32*32.
"""

import io
import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "valid"]

DATA_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"
LABEL_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "imagelabels.mat")
SETID_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat"
DATA_MD5 = "52808999861908f626f3c1f4e79d11fa"
LABEL_MD5 = "e0620be6f572b9609742df49c70aed4d"
SETID_MD5 = "a5357ecc9cb78c4bef273ce3793fc85c"

# the official readme's 'tstid' is the larger split; the reference
# swaps it in as training data (flowers.py:50-55)
TRAIN_FLAG = "tstid"
TEST_FLAG = "trnid"
VALID_FLAG = "valid"

CLASS_NUM = 102
_DIM = 3 * 32 * 32


def default_mapper(sample):
    """JPEG bytes -> flattened CHW float32 in [0,1] (resize-256 /
    center-crop-224, the reference simple_transform shape contract)."""
    from PIL import Image

    img_bytes, label = sample
    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    w, h = img.size
    scale = 256.0 / min(w, h)
    img = img.resize((int(round(w * scale)), int(round(h * scale))))
    w, h = img.size
    left, top = (w - 224) // 2, (h - 224) // 2
    img = img.crop((left, top, left + 224, top + 224))
    arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    return arr.flatten(), label


def _real_reader(flag, mapper):
    data_path = common.maybe_download(DATA_URL, "flowers", DATA_MD5)
    label_path = common.maybe_download(LABEL_URL, "flowers", LABEL_MD5)
    setid_path = common.maybe_download(SETID_URL, "flowers", SETID_MD5)
    if not (data_path and label_path and setid_path):
        return None
    import scipy.io as scio

    labels = scio.loadmat(label_path)["labels"][0]
    indexes = scio.loadmat(setid_path)[flag][0]

    wanted = {"image_%05d.jpg" % idx: int(labels[idx - 1]) - 1
              for idx in indexes}

    def reader():
        # stream the tar sequentially (archive order, not setid order):
        # random access into a .tgz re-decompresses from offset 0 per
        # backward seek — quadratic over the ~330MB archive
        with tarfile.open(data_path) as tf:
            tm = tf.next()
            while tm is not None:
                base = tm.name.split("/")[-1]
                if tm.isfile() and base in wanted:
                    img_bytes = tf.extractfile(tm).read()
                    yield mapper((img_bytes, wanted[base]))
                tm = tf.next()

    return reader


def _synth(split, n):
    def reader():
        rng = common.synth_rng("flowers", split)
        protos = rng.rand(CLASS_NUM, _DIM).astype(np.float32)
        for _ in range(n):
            y = int(rng.randint(0, CLASS_NUM))
            x = np.clip(protos[y] + 0.1 * rng.randn(_DIM), 0, 1)
            yield (x.astype(np.float32), y)

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return (_real_reader(TRAIN_FLAG, mapper or default_mapper)
            or _synth("train", 6144))


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return (_real_reader(TEST_FLAG, mapper or default_mapper)
            or _synth("test", 1024))


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return (_real_reader(VALID_FLAG, mapper or default_mapper)
            or _synth("valid", 1024))
