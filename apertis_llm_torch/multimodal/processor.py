"""Standalone text + image batch preprocessor.

The counterpart of ``apertis_llm_tpu/multimodal/processor.py`` (reference:
src/multimodal/module.py:164-410): it holds a ViT encoder and a cross-modal
head (one pre-norm ViT block with 8 heads, ``output_projection`` and
``output_norm``), processes (text, image) samples with an image cache and
returns the combined feature dict. Datasets and examples use it; the
training path does not.

The weights are f32, drawn from an explicit ``torch.Generator`` with the JAX
processor's distributions (the numbers differ, since each package has its
own generator); :meth:`MultimodalDataProcessor.load_params` takes a tree
named like the JAX processor's ``params`` (numpy or torch leaves), so that
both compute with one set of weights. The processor runs on the card unless
``device`` names another.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import Linear, Norm
from apertis_llm_torch.models.convert import copy_tree
from apertis_llm_torch.models.params import _Init, _init_vision, resolve_device
from apertis_llm_torch.models.vit import VIT_LN_EPS, VisionEncoder, VitLayer
from apertis_llm_torch.ops.norms import layer_norm
from apertis_llm_torch.utils.images import load_image

CROSS_MODAL_HEADS = 8


def init_processor_params(config: ApertisConfig, generator: torch.Generator,
                          device) -> Dict[str, Any]:
    """The processor's tree (processor.py:47-64): the ViT's, the cross-modal
    block (unit LayerNorms, ``in_proj_w`` normal(0, 0.02), the linears
    normal(0, 0.02), zero biases), ``output_projection`` and
    ``output_norm``, all f32."""
    init = _Init(generator, device, torch.float32)
    dv = config.vision_embed_dim
    ones = lambda: {"w": init.full((dv,), 1.0), "b": init.full((dv,), 0.0)}   # noqa: E731
    return {
        "encoder": _init_vision(init, config),
        "cross_modal": {
            "ln1": ones(),
            "in_proj_w": init.normal((dv, 3 * dv), 0.02),
            "in_proj_b": init.full((3 * dv,), 0.0),
            "attn_out": init.linear((), dv, dv, 0.02, bias=True),
            "ln2": ones(),
            "linear1": init.linear((), dv, 4 * dv, 0.02, bias=True),
            "linear2": init.linear((), 4 * dv, dv, 0.02, bias=True),
        },
        "output_projection": init.linear((), dv, dv, 0.02, bias=True),
        "output_norm": ones(),
    }


class MultimodalDataProcessor(nn.Module):
    def __init__(
        self,
        image_size: int = 224,
        max_text_length: int = 512,
        vision_embed_dim: int = 768,
        vision_patch_size: int = 16,
        vision_heads: int = 12,
        vision_layers: int = 12,
        use_cache: bool = True,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.image_size = image_size
        self.max_text_length = max_text_length
        self.vision_embed_dim = vision_embed_dim
        self.vision_heads = vision_heads
        self.image_cache: Optional[Dict[str, np.ndarray]] = {} if use_cache else None
        self.config = ApertisConfig(
            image_size=image_size, vision_embed_dim=vision_embed_dim,
            vision_patch_size=vision_patch_size, vision_heads=vision_heads,
            vision_layers=vision_layers, multimodal=True)
        f32, dv = torch.float32, vision_embed_dim
        self.encoder = VisionEncoder(self.config, device, f32)
        self.cross_modal = VitLayer(self.config, device, f32, False, heads=CROSS_MODAL_HEADS)
        self.output_projection = Linear(dv, dv, True, device, f32)
        self.output_norm = Norm(dv, False, VIT_LN_EPS, device, f32)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.load_params(init_processor_params(self.config, generator, device))
        self.requires_grad_(False)    # a preprocessor, as JAX's pure forward

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Copy a tree named like the JAX processor's ``params``
        (``encoder``, ``cross_modal``, ``output_projection``,
        ``output_norm``; the encoder's layers stacked) into the processor."""
        copy_tree(self, tree, {"encoder.layers.": ("vision_layers", self.config.vision_layers)})

    @torch.no_grad()
    def forward(self, input_ids, attention_mask, pixel_values) -> Dict[str, Any]:
        """The ViT's features of (B, 3, S, S) ``pixel_values``, through the
        cross-modal block, ``output_projection`` and ``output_norm``
        (processor.py:67-82); the ids and the mask pass through."""
        dev = self.output_norm.w.device
        vision_features = self.encoder(torch.as_tensor(pixel_values, device=dev))
        proj = self.output_projection(self.cross_modal(vision_features))
        combined = layer_norm(proj, self.output_norm.w, self.output_norm.b, VIT_LN_EPS)
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "vision_features": vision_features,
            "combined_features": combined,
        }

    # -- host-side helpers ---------------------------------------------
    def _image(self, image_path: str) -> np.ndarray:
        if self.image_cache is not None and image_path in self.image_cache:
            return self.image_cache[image_path]
        arr = load_image(image_path, self.image_size)
        if self.image_cache is not None:
            self.image_cache[image_path] = arr
        return arr

    def process_sample(
        self,
        text: str,
        image_path: Optional[str] = None,
        tokenizer: Any = None,
        raw_image: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """One sample's (1, max_text_length) ids and mask, and its
        ``pixel_values`` from ``raw_image`` or the (cached) file: an HF
        tokenizer pads to the length, another one's ``encode`` is truncated
        and padded with 0, and without one each word hashes to an id."""
        if tokenizer is not None:
            if hasattr(tokenizer, "__call__") and hasattr(tokenizer, "pad_token_id"):
                enc = tokenizer(text, truncation=True, padding="max_length",
                                max_length=self.max_text_length)
                ids = np.asarray([enc["input_ids"]], np.int32)
                mask = np.asarray([enc["attention_mask"]], np.int32)
            else:
                raw = tokenizer.encode(text)[: self.max_text_length]
                pad = self.max_text_length - len(raw)
                ids = np.asarray([raw + [0] * pad], np.int32)
                mask = np.asarray([[1] * len(raw) + [0] * pad], np.int32)
        else:
            words = text.split()[: self.max_text_length]
            ids = np.asarray([[hash(w) % 30000 + 4 for w in words]
                              + [0] * (self.max_text_length - len(words))], np.int32)
            mask = (ids != 0).astype(np.int32)

        out = {"input_ids": ids, "attention_mask": mask}
        if raw_image is not None:
            out["pixel_values"] = np.asarray(raw_image, np.float32)
        elif image_path is not None:
            out["pixel_values"] = self._image(image_path)
        return out

    def process_batch(self, samples: List[Dict[str, Any]],
                      tokenizer: Any = None) -> Dict[str, np.ndarray]:
        """The samples' arrays concatenated; a key that some samples lack
        (``pixel_values``) is left out."""
        processed = [self.process_sample(s.get("text", ""), s.get("image_path"), tokenizer,
                                         s.get("raw_image")) for s in samples]
        keys = set().union(*(p.keys() for p in processed))
        batch = {}
        for key in keys:
            rows = [p[key] for p in processed if key in p]
            if len(rows) == len(processed):
                batch[key] = np.concatenate(rows, axis=0)
        return batch
