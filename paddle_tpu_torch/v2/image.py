"""Image helpers of the v2 readers (``paddle_tpu/v2/image.py``), numpy
only: HWC arrays resized on the short edge (nearest neighbour), cropped
at the centre or at random, flipped, and turned to CHW."""

import numpy as np

__all__ = ["to_chw", "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "resize_short"]


def to_chw(img, order=(2, 0, 1)):
    return img.transpose(order)


def center_crop(img, size, is_color=True):
    h, w = img.shape[:2]
    sh = max((h - size) // 2, 0)
    sw = max((w - size) // 2, 0)
    return img[sh:sh + size, sw:sw + size]


def random_crop(img, size, is_color=True):
    h, w = img.shape[:2]
    sh = np.random.randint(0, max(h - size, 0) + 1)
    sw = np.random.randint(0, max(w - size, 0) + 1)
    return img[sh:sh + size, sw:sw + size]


def left_right_flip(img):
    return img[:, ::-1]


def simple_transform(img, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """Resize the short edge, crop (at random and flip half the time when
    ``is_train``, else at the centre), CHW float32, ``mean`` taken off
    each channel."""
    img = resize_short(img, resize_size)
    img = (random_crop(img, crop_size) if is_train
           else center_crop(img, crop_size))
    if is_train and np.random.randint(2):
        img = left_right_flip(img)
    img = to_chw(img).astype(np.float32)
    if mean is not None:
        img -= np.asarray(mean).reshape(-1, 1, 1)
    return img


def resize_short(img, size):
    """The short edge to ``size`` by nearest neighbour, the aspect kept."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    ys = (np.arange(nh) * h / nh).astype(int)
    xs = (np.arange(nw) * w / nw).astype(int)
    return img[ys][:, xs]
