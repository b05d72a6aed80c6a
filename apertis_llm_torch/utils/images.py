"""Host-side image loading (PIL) into model-ready pixel arrays.

A copy of ``apertis_llm_tpu/utils/images.py``: torchvision's Resize ->
ToTensor -> Normalize(ImageNet) pipeline of the reference (interface.py:
457-471, multimodal/module.py:27-31), with PIL's bilinear resize to a square
of ``image_size``. A file that cannot be read or decoded is logged and
becomes a blank image, as the reference degrades (module.py:139-142).

One difference: PIL is imported when an image is loaded, and where it is not
installed :func:`load_image` raises ``ImportError`` instead of returning a
blank, since every image would otherwise train as a blank without a word.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("loading images needs PIL (the pillow package), which is not "
                          "installed") from e
    return Image


def load_image(image_path: str, image_size: int = 224) -> np.ndarray:
    """Load, resize and normalise one image -> (1, 3, S, S) float32; a file
    that cannot be read is logged and gives zeros."""
    image = _pil_image()
    try:
        img = image.open(image_path).convert("RGB")
        img = img.resize((image_size, image_size), image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0           # (S, S, 3)
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr.transpose(2, 0, 1)[None]                  # (1, 3, S, S)
    except Exception as e:
        logger.error("Error preprocessing image %s: %s", image_path, e)
        return np.zeros((1, 3, image_size, image_size), np.float32)


def load_image_batch(paths: Sequence[str], image_size: int = 224) -> np.ndarray:
    return np.concatenate([load_image(p, image_size) for p in paths], axis=0)


def create_sample_image(path: Optional[str] = None, size: int = 224) -> np.ndarray:
    """The gradient test image (reference: multimodal/module.py:413-436),
    (size, size, 3) float32 in [0, 1]; saved as a PNG to ``path`` if given."""
    x = np.linspace(0, 1, size, dtype=np.float32)
    r = np.tile(x, (size, 1))
    g = r.T
    b = 0.5 * np.ones((size, size), np.float32)
    img = np.stack([r, g, b], axis=-1)
    if path is not None:
        _pil_image().fromarray((img * 255).astype(np.uint8)).save(path)
    return img
