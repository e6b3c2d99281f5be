"""Image helpers for the v1 preprocessing tools (reference:
python/paddle/utils/image_util.py — resize/crop/flip/oversample/mean).
Dense math is numpy; decoding goes through PIL.  The richer v2-era
transforms live in paddle_tpu_torch.v2.image."""

import numpy as np

__all__ = ["resize_image", "flip", "crop_img", "oversample",
           "load_image", "preprocess_img", "load_meta"]


def load_image(img_path, is_color=True):
    """→ HWC uint8 array."""
    from PIL import Image

    img = Image.open(img_path)
    img = img.convert("RGB" if is_color else "L")
    arr = np.asarray(img)
    if not is_color:
        arr = arr[:, :, None]
    return arr


def resize_image(img, target_size):
    """Resize the SHORT side to ``target_size``, keeping aspect
    (reference image_util.resize_image semantics)."""
    from PIL import Image

    h, w = img.shape[0], img.shape[1]
    if h < w:
        nh, nw = target_size, max(1, int(round(w * target_size / h)))
    else:
        nh, nw = max(1, int(round(h * target_size / w))), target_size
    pil = Image.fromarray(img.squeeze() if img.shape[-1] == 1 else img)
    out = np.asarray(pil.resize((nw, nh), Image.BILINEAR))
    if img.shape[-1] == 1:
        out = out[:, :, None]
    return out


def flip(im):
    """Horizontal mirror (HWC)."""
    return im[:, ::-1]


def crop_img(im, inner_size, color=True, test=True):
    """Center crop when ``test``, random crop + random flip otherwise."""
    h, w = im.shape[0], im.shape[1]
    if test:
        top, left = (h - inner_size) // 2, (w - inner_size) // 2
    else:
        top = np.random.randint(0, h - inner_size + 1)
        left = np.random.randint(0, w - inner_size + 1)
    out = im[top:top + inner_size, left:left + inner_size]
    if not test and np.random.randint(2):
        out = flip(out)
    return out


def oversample(img, crop_dims):
    """10-crop TTA: 4 corners + center, plus mirrors (reference
    image_util.oversample) — img HWC → (10, crop, crop, C)."""
    h, w = img.shape[0], img.shape[1]
    ch, cw = crop_dims, crop_dims
    offsets = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
               ((h - ch) // 2, (w - cw) // 2)]
    crops = [img[t:t + ch, l:l + cw] for t, l in offsets]
    crops += [flip(c) for c in crops]
    return np.stack(crops)


def preprocess_img(im, img_mean, crop_size, is_train, color=True):
    """crop → CHW float → mean-subtract (reference
    image_util.preprocess_img)."""
    cropped = crop_img(im, crop_size, color, test=not is_train)
    chw = cropped.astype("float32").transpose(2, 0, 1)
    return (chw - img_mean).ravel()


def load_meta(meta_path, mean_img_size, crop_size, color=True):
    """Load the dataset mean image (.npz with key 'mean') and
    center-crop it to ``crop_size`` CHW."""
    with np.load(meta_path) as d:
        mean = d["mean"]
    if mean.ndim == 1:
        c = 3 if color else 1
        mean = mean.reshape(c, mean_img_size, mean_img_size)
    border = (mean_img_size - crop_size) // 2
    return mean[:, border:border + crop_size,
                border:border + crop_size].astype("float32")
