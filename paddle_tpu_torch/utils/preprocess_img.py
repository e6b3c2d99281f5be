"""Image-classification dataset builder (reference:
python/paddle/utils/preprocess_img.py ImageClassificationDatasetCreater
— resize to a common size, accumulate the mean image, write batches)."""

import os

import numpy as np

from paddle_tpu_torch.utils import image_util
from paddle_tpu_torch.utils.preprocess_util import DatasetCreater, save_batch

__all__ = ["ImageClassificationDatasetCreater"]


class ImageClassificationDatasetCreater(DatasetCreater):
    def __init__(self, data_path, target_size=32, batch_size=128,
                 test_ratio=0.1, color=True):
        super().__init__(data_path, batch_size, test_ratio)
        self.target_size = target_size
        self.color = color

    def _load(self, path):
        img = image_util.load_image(path, self.color)
        img = image_util.resize_image(img, self.target_size)
        img = image_util.crop_img(img, self.target_size, self.color,
                                  test=True)
        return img.astype("float32").transpose(2, 0, 1)  # CHW

    def create(self, out_dir):
        train, test = self.create_dataset(out_dir, self._load)
        # dataset mean image over the train batches
        total, count = None, 0
        for fn in train:
            with np.load(fn) as d:
                s = d["data"].sum(axis=0)
                count += d["data"].shape[0]
            total = s if total is None else total + s
        mean = (total / max(count, 1)).astype("float32")
        np.savez(os.path.join(out_dir, "meta.npz"), mean=mean)
        return train, test
