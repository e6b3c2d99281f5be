"""Parallel image preprocessing over a reader (reference:
python/paddle/utils/image_multiproc.py PixelTransformer pools — worker
processes decoding/augmenting ahead of the trainer).  Built on the v2
``xmap_readers`` thread pipeline: decode/augment workers keep the
feed ahead of the trainer's steps."""

from paddle_tpu_torch.v2.reader.decorator import xmap_readers

__all__ = ["PixelTransformer", "multiproc_reader"]


def multiproc_reader(reader, mapper, workers=4, buffer_size=64,
                     order=False):
    """``reader`` samples → ``mapper(sample)`` on ``workers`` threads."""
    return xmap_readers(mapper, reader, workers, buffer_size, order)


class PixelTransformer:
    """resize→crop→mean-subtract pipeline as a picklable callable
    (reference image_multiproc.PixelTransformer)."""

    def __init__(self, target_size, crop_size, img_mean=None,
                 is_train=True, color=True):
        self.target_size = target_size
        self.crop_size = crop_size
        self.img_mean = img_mean
        self.is_train = is_train
        self.color = color

    def __call__(self, sample):
        from paddle_tpu_torch.utils import image_util

        img, label = sample
        img = image_util.resize_image(img, self.target_size)
        img = image_util.crop_img(img, self.crop_size, self.color,
                                  test=not self.is_train)
        chw = img.astype("float32").transpose(2, 0, 1)
        if self.img_mean is not None:
            chw = chw - self.img_mean
        return chw, label
