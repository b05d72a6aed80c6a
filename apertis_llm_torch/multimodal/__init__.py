"""Multimodal pieces outside the model: the data processor and the image
loading helpers (``apertis_llm_tpu/multimodal``); the ViT itself is
``models/vit.py``."""

from apertis_llm_torch.models.vit import preprocess_images
from apertis_llm_torch.multimodal.processor import MultimodalDataProcessor
from apertis_llm_torch.utils.images import create_sample_image, load_image, load_image_batch

__all__ = ["preprocess_images", "MultimodalDataProcessor", "create_sample_image", "load_image",
           "load_image_batch"]
