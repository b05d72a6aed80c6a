"""The port's image loading and multimodal data processor vs the JAX
package's (CPU).

PNGs are written here with PIL: ``load_image``, ``load_image_batch`` and
``create_sample_image`` must give JAX's arrays bit for bit (the same PIL
resize and the same f32 normalisation); a file that is no image gives the
logged blank; without PIL the port raises ``ImportError`` where JAX would
return blanks. The processor's forward and ``process_batch`` are held
against JAX's on the JAX processor's own weights, carried over as numpy.
"""

import logging
import sys

import numpy as np
import pytest
import torch

import jax

from apertis_llm_tpu.multimodal.processor import MultimodalDataProcessor as JaxProcessor
from apertis_llm_tpu.utils import images as jax_images
from apertis_llm_torch.multimodal import MultimodalDataProcessor
from apertis_llm_torch.utils import images

torch.set_num_threads(2)

PROC = dict(image_size=32, max_text_length=12, vision_embed_dim=64, vision_patch_size=8,
            vision_heads=4, vision_layers=2)


def _pngs(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate(((40, 48, 3), (20, 24, 3), (32, 32, 4))):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(path)
        paths.append(str(path))
    return paths


def test_load_image_and_batch_match_jax(tmp_path):
    """RGB and RGBA PNGs, shrunk and grown to 32 and 224: (1, 3, S, S)
    float32, bit-equal to JAX's; a batch concatenates them."""
    paths = _pngs(tmp_path)
    for size in (32, 224):
        for path in paths:
            got, ref = images.load_image(path, size), jax_images.load_image(path, size)
            assert got.shape == (1, 3, size, size) and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(images.load_image_batch(paths, 32),
                                  jax_images.load_image_batch(paths, 32))


def test_create_sample_image_matches_jax(tmp_path):
    """The gradient image as an array and as the PNG it writes."""
    np.testing.assert_array_equal(images.create_sample_image(size=40),
                                  jax_images.create_sample_image(size=40))
    images.create_sample_image(str(tmp_path / "a.png"), size=40)
    jax_images.create_sample_image(str(tmp_path / "b.png"), size=40)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(images.load_image(str(tmp_path / "a.png"), 32),
                                  jax_images.load_image(str(tmp_path / "b.png"), 32))


def test_unreadable_file_gives_a_logged_blank(tmp_path, caplog):
    """A missing file and one that is no image: zeros of the right shape,
    and the error logged, as the reference degrades."""
    bad = tmp_path / "bad.png"
    bad.write_text("not an image")
    for path in (str(bad), str(tmp_path / "missing.png")):
        with caplog.at_level(logging.ERROR, logger=images.__name__):
            got = images.load_image(path, 32)
        assert got.shape == (1, 3, 32, 32) and not got.any()
        np.testing.assert_array_equal(got, jax_images.load_image(path, 32))
    assert sum(r.name == images.__name__ and "Error preprocessing image" in r.getMessage()
               for r in caplog.records) == 2


def test_missing_pil_raises(tmp_path, monkeypatch):
    """Without PIL, loading or saving an image raises ``ImportError`` naming
    PIL (JAX's loader would return blanks); the array-only sample image
    needs no PIL."""
    path = _pngs(tmp_path)[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        images.load_image(path, 32)
    with pytest.raises(ImportError, match="PIL"):
        images.create_sample_image(str(tmp_path / "c.png"), size=8)
    assert images.create_sample_image(size=8).shape == (8, 8, 3)


def _processors(**over):
    kw = dict(PROC, **over)
    jproc = JaxProcessor(rng=jax.random.PRNGKey(3), **kw)
    proc = MultimodalDataProcessor(device="cpu", **kw)
    proc.load_params(jax.tree.map(np.asarray, jproc.params))
    return jproc, proc


def test_processor_forward_matches_jax():
    """The ViT, the 8-head cross-modal block, ``output_projection`` and
    ``output_norm`` on the JAX processor's weights: vision and combined
    features within 1e-5 of the largest value (f32 sums in other orders)."""
    jproc, proc = _processors()
    pixels = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ids, mask = np.ones((2, 12), np.int32), np.ones((2, 12), np.int32)
    ref = jproc(ids, mask, pixels)
    got = proc(ids, mask, pixels)
    assert proc.cross_modal.heads == 8
    for key in ("vision_features", "combined_features"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape == (2, 17, 64)
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), key
    assert got["input_ids"] is ids


def test_processor_own_weights_follow_the_jax_distributions():
    """Weights from an explicit generator: the same names and shapes as the
    JAX processor's, unit LayerNorms, zero biases, and another seed gives
    other weights."""
    jproc = JaxProcessor(**PROC)
    a = MultimodalDataProcessor(generator=torch.Generator().manual_seed(0), device="cpu", **PROC)
    b = MultimodalDataProcessor(generator=torch.Generator().manual_seed(1), device="cpu", **PROC)
    shapes = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(jproc.params)[0]}
    stacked = sum(s[0] if n.startswith("encoder.layers.") else 1 for n, s in shapes.items())
    assert stacked == len(dict(a.named_parameters()))
    assert torch.equal(a.cross_modal.ln1.w, torch.ones(64))
    assert not a.output_projection.b.any()
    assert 0.015 < float(a.cross_modal.in_proj_w.std()) < 0.025
    assert not any(p.requires_grad for p in a.parameters())
    assert not torch.equal(a.cross_modal.in_proj_w, b.cross_modal.in_proj_w)


def test_process_batch_matches_jax(tmp_path):
    """``process_batch`` over samples with image files (one cached, one
    unreadable), a raw image, and none: ids, masks and pixels as JAX's, the
    pixels left out where a sample has none; the cache keeps each path."""
    paths = _pngs(tmp_path)
    jproc, proc = _processors()
    raw = np.random.default_rng(2).normal(size=(1, 3, 32, 32)).astype(np.float32)
    with_images = [{"text": "a b c", "image_path": paths[0]},
                   {"text": "d e f g h", "image_path": paths[1]},
                   {"text": "a b", "image_path": paths[0]},
                   {"text": "x y z", "image_path": str(tmp_path / "missing.png")},
                   {"text": "q r", "raw_image": raw}]
    for samples in (with_images, with_images + [{"text": "no image here"}]):
        got, ref = proc.process_batch(samples), jproc.process_batch(samples)
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    assert "pixel_values" not in got
    assert set(proc.image_cache) == {paths[0], paths[1], str(tmp_path / "missing.png")}
