"""PASCAL VOC2012 segmentation (reference:
python/paddle/v2/dataset/voc2012.py).

Real path: the VOCtrainval tarball's ImageSets/Segmentation lists +
JPEGImages/SegmentationClass pairs decoded with PIL (reference
voc2012.py:42-85; split naming follows it: train()='trainval',
test()='train', val()='val').  Records: (float32[3,H,W] image in
[0,1], int32[H,W] label mask in [0,21) with 255=ignore) — the
reference yields raw uint8 arrays; this module normalizes to the model
input contract its consumers use.

Offline fallback: synthetic scenes of axis-aligned object rectangles
painting image hue and mask consistently.
"""

import io
import tarfile

import numpy as np

from paddle_tpu_torch.v2.dataset import common

__all__ = ["train", "test", "val"]

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

CLASS_NUM = 21  # 20 objects + background
IGNORE_LABEL = 255
_H = _W = 64


def _real_reader(sub_name):
    tar_path = common.maybe_download(VOC_URL, "voc2012", VOC_MD5)
    if tar_path is None:
        return None
    from PIL import Image

    def reader():
        with tarfile.open(tar_path) as tf:
            members = {m.name: m for m in tf.getmembers() if m.isfile()}
            sets = tf.extractfile(members[SET_FILE.format(sub_name)])
            for line in sets:
                name = line.decode("utf-8").strip()
                if not name:
                    continue
                data = tf.extractfile(members[DATA_FILE.format(name)]).read()
                label = tf.extractfile(
                    members[LABEL_FILE.format(name)]).read()
                img = Image.open(io.BytesIO(data)).convert("RGB")
                msk = Image.open(io.BytesIO(label))
                img_arr = (np.asarray(img, np.float32)
                           .transpose(2, 0, 1) / 255.0)
                msk_arr = np.asarray(msk, np.int32)
                yield img_arr, msk_arr

    return reader


def _synth(split, n):
    def reader():
        rng = common.synth_rng("voc2012", split)
        palette = rng.rand(CLASS_NUM, 3).astype(np.float32)
        for _ in range(n):
            img = np.tile(palette[0].reshape(3, 1, 1), (1, _H, _W))
            mask = np.zeros((_H, _W), np.int32)
            for _ in range(int(rng.randint(1, 4))):
                cls = int(rng.randint(1, CLASS_NUM))
                h0, w0 = rng.randint(0, _H - 8), rng.randint(0, _W - 8)
                h1 = h0 + rng.randint(8, _H - h0 + 1)
                w1 = w0 + rng.randint(8, _W - w0 + 1)
                img[:, h0:h1, w0:w1] = palette[cls].reshape(3, 1, 1)
                mask[h0:h1, w0:w1] = cls
                # thin ignore border, as in real VOC annotations
                mask[h0, w0:w1] = IGNORE_LABEL
            noise = 0.05 * rng.randn(3, _H, _W)
            yield (np.clip(img + noise, 0, 1).astype(np.float32), mask)

    return reader


def train():
    """'trainval' list, mirroring the reference's train() (voc2012.py:67)."""
    return _real_reader("trainval") or _synth("train", 1464)


def test():
    return _real_reader("train") or _synth("test", 512)


def val():
    return _real_reader("val") or _synth("val", 512)
