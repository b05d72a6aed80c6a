"""User-facing inference interfaces (``apertis_llm_tpu/inference/interface.py``).

* :class:`ApertisInterface` — the model and tokenizer lifecycle, the chat
  loop and the web-UI launcher (reference: src/inference/interface.py:
  29-550): HF-tokenizer discovery, the manual vocabulary fallback, config
  inference from bare state_dicts, role-formatted chat prompts.
* :class:`ApertisInference` — the ``messages=[...]`` streaming API the
  examples drive (examples/simple_chat.py:56-94).

The model is served on the card unless ``device`` names another, in the
checkpoint's dtype (f32 from ``load_pretrained``) unless ``dtype`` casts it
(``InferenceEngine(dtype=...)``), with ``quantize="int8"`` through
``models/quantize.py::quantize_params`` on the device. ``chat`` and
``generate_response`` take ``stream=True`` to yield the reply's text as it
grows, through ``InferenceEngine.stream``.

Two differences from the JAX package. A serving mesh (``mesh_shape``)
raises ``NotImplementedError``: the engine takes no mesh yet (ROADMAP.md
queue 1, item 5.6). And only a checkpoint that cannot be read or built
falls back to the dummy startup model, as the JAX package falls back on any
error (interface.py:176-180): an error of the device, of a kernel's build
or of its launch propagates, so a failing card is never served as a dummy.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any, Dict, Generator, Iterable, List, Optional, Union

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.inference.engine import InferenceEngine
from apertis_llm_torch.models.convert import from_jax_params, read_pretrained, tree_to
from apertis_llm_torch.models.params import init_params, resolve_device
from apertis_llm_torch.models.quantize import quantize_params
from apertis_llm_torch.utils.images import load_image
from apertis_llm_torch.utils.vocab import (
    ManualTokenizer, fallback_vocab, load_vocabulary, try_load_hf_tokenizer,
    vocab_size_from_mapping)

logger = logging.getLogger(__name__)


class ApertisInterface:
    """Model + tokenizer lifecycle and chat. ``params`` is the served tree
    (on the device, int8 under ``quantize="int8"``), ``model`` the engine's
    model, which the engine's serving attachments change; the evaluation
    harness scores ``params``, as the JAX harness scores its tree."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        vocab_file: Optional[str] = None,
        multimodal: bool = False,
        device: Optional[str] = None,
        web: bool = False,
        port: int = 7860,
        dtype: Optional[str] = None,
        quantize: Optional[str] = None,
        mesh_shape: Optional[List[int]] = None,
    ):
        if quantize not in (None, "", "int8"):
            raise ValueError(f"Unsupported quantize mode: {quantize!r} "
                             "(expected 'int8')")
        if mesh_shape:
            raise NotImplementedError(
                "serving over a device mesh (mesh_shape) is not ported to PyTorch yet: "
                "the engine takes no mesh (ROADMAP.md queue 1, item 5.6)")
        self.device = resolve_device(device if device is not None else "cuda")
        self.model_path_arg = model_path
        self.vocab_file_fallback_arg = vocab_file
        self.multimodal = multimodal
        self.port = port
        self.dtype = dtype
        self.quantize = quantize or None

        self.config: Optional[ApertisConfig] = None
        self.params = None
        self.model = None
        self.engine: Optional[InferenceEngine] = None
        self.hf_tokenizer_chat = None
        self.manual_tokenizer: Optional[ManualTokenizer] = None
        self.actual_model_path_loaded: Optional[str] = None
        self.actual_tokenizer_path_loaded: Optional[str] = None
        self.chat_history: List[Dict[str, str]] = []

        # Cooperative stop events for UI-launched training threads
        # (reference: interface.py:72-77).
        self.standard_training_stop_event = threading.Event()
        self.azr_training_stop_event = threading.Event()
        self.finetune_training_stop_event = threading.Event()
        self.standard_training_thread: Optional[threading.Thread] = None
        self.azr_training_thread: Optional[threading.Thread] = None
        self.finetune_training_thread: Optional[threading.Thread] = None

        if model_path is not None:
            self.load_model_and_tokenizer_from_path(
                model_path, vocab_file_override=vocab_file)
        else:
            logger.info("No initial model path; creating dummy startup model.")
            self._create_dummy_model_and_vocab()

        if web:
            self.launch_web_interface()

    # -- loading ---------------------------------------------------------
    def _create_dummy_model_and_vocab(self) -> None:
        config = ApertisConfig(vocab_size=100, hidden_size=64,
                               num_hidden_layers=1, num_attention_heads=1,
                               intermediate_size=128)
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.config, self.params = config, init_params(config, gen, device=self.device)
        self.model = from_jax_params(self.params, config, device=self.device)
        self.engine = InferenceEngine(config, self.model, dtype=self.dtype)
        self.actual_model_path_loaded = "Dummy Startup Model"
        vocab = fallback_vocab(100)
        self.manual_tokenizer = ManualTokenizer(vocab, model_vocab_size=100)
        self.actual_tokenizer_path_loaded = "Dummy Startup Vocab"
        self.multimodal = config.multimodal

    def load_model_and_tokenizer_from_path(
        self, model_path_or_name: str,
        vocab_file_override: Optional[str] = None,
    ) -> None:
        # Tokenizer discovery: model dir first, then explicit vocab file.
        path = Path(model_path_or_name)
        tok_dir = path if path.is_dir() else path.parent
        self.hf_tokenizer_chat = try_load_hf_tokenizer(str(tok_dir))
        if self.hf_tokenizer_chat is not None:
            self.actual_tokenizer_path_loaded = str(tok_dir)

        self.load_model(model_path_or_name)

        if self.hf_tokenizer_chat is None:
            vocab_candidates = []
            if vocab_file_override:
                vocab_candidates.append(Path(vocab_file_override))
            vocab_candidates.append(tok_dir / "vocab.json")
            for cand in vocab_candidates:
                if cand.exists():
                    self.load_manual_vocabulary(str(cand))
                    break
            else:
                logger.warning("No tokenizer/vocab found; using fallback vocab.")
                self._set_fallback_vocab()

    def load_model(self, model_path: str) -> None:
        """Read the checkpoint, quantize it under ``quantize="int8"`` and
        serve it. A checkpoint that cannot be read, or whose tree the port
        cannot build, falls back to the dummy model; errors of the device
        and the kernels propagate."""
        try:
            config, tree = read_pretrained(model_path)
        except Exception as e:
            logger.error("Error loading model from %s: %s", model_path, e, exc_info=True)
            logger.info("Falling back to dummy model.")
            self._create_dummy_model_and_vocab()
            return
        if self.hf_tokenizer_chat is not None:
            tok = self.hf_tokenizer_chat
            # Align special ids with the tokenizer but keep the weight
            # shapes authoritative for vocab_size (the reference resizes to
            # the state_dict's size on mismatch, interface.py:243-251).
            for attr in ("pad_token_id", "bos_token_id", "eos_token_id", "unk_token_id"):
                tid = getattr(tok, attr, None)
                if tid is not None:
                    setattr(config, attr, tid)
        tree = tree_to(tree, self.device)
        if self.quantize == "int8":
            tree = quantize_params(tree)
            logger.info("Quantized serving weights to int8")
        try:
            model = from_jax_params(tree, config, device=self.device)
        except (KeyError, ValueError, NotImplementedError) as e:
            logger.error("Error building the model of %s: %s", model_path, e, exc_info=True)
            logger.info("Falling back to dummy model.")
            self._create_dummy_model_and_vocab()
            return
        self.config, self.params, self.model = config, tree, model
        self.engine = InferenceEngine(config, model, dtype=self.dtype)
        self.actual_model_path_loaded = str(model_path)
        self.multimodal = config.multimodal
        logger.info("Model loaded from %s (vocab=%d, attn=%s)",
                    model_path, config.vocab_size, config.attention_type)

    def _set_fallback_vocab(self) -> None:
        vocab = fallback_vocab(100)
        self.manual_tokenizer = ManualTokenizer(
            vocab, model_vocab_size=self.config.vocab_size if self.config else 100)
        self.actual_tokenizer_path_loaded = "Fallback minimal vocab (100 tokens)"

    def load_manual_vocabulary(self, vocab_file: str) -> None:
        try:
            vocab = load_vocabulary(vocab_file)
            if not vocab:
                logger.warning("Empty vocab file %s; using fallback.", vocab_file)
                self._set_fallback_vocab()
                return
            size = vocab_size_from_mapping(vocab)
            model_size = self.config.vocab_size if self.config else size
            if model_size != size:
                logger.warning(
                    "Model vocab_size (%d) != vocab file effective size (%d).",
                    model_size, size)
            self.manual_tokenizer = ManualTokenizer(
                vocab,
                unk_token_id=self.config.unk_token_id if self.config else 3,
                model_vocab_size=model_size)
            self.actual_tokenizer_path_loaded = vocab_file
        except Exception as e:
            logger.error("Error loading vocab %s: %s", vocab_file, e)
            self._set_fallback_vocab()

    # -- tokenisation ----------------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        if self.hf_tokenizer_chat is not None:
            return self.hf_tokenizer_chat.encode(text, add_special_tokens=False)
        if self.manual_tokenizer is None:
            self._set_fallback_vocab()
        return self.manual_tokenizer.encode(text)

    def detokenize(self, token_ids: Iterable[int]) -> str:
        token_ids = list(int(t) for t in token_ids)
        if self.hf_tokenizer_chat is not None:
            return self.hf_tokenizer_chat.decode(token_ids, skip_special_tokens=True)
        if self.manual_tokenizer is None:
            self._set_fallback_vocab()
        cfg = self.config
        skip = (cfg.pad_token_id, cfg.bos_token_id, cfg.eos_token_id) if cfg else (0, 1, 2)
        return self.manual_tokenizer.decode(token_ids, skip_ids=skip)

    def preprocess_image(self, image_path: str) -> np.ndarray:
        size = self.config.image_size if self.config else 224
        return load_image(image_path, size)

    # -- generation ------------------------------------------------------
    def _encode_prompt(self, prompt: str) -> List[int]:
        if self.hf_tokenizer_chat is not None:
            return self.hf_tokenizer_chat.encode(prompt, add_special_tokens=True)
        ids = self.tokenize(prompt)
        bos = self.config.bos_token_id
        if not ids or ids[0] != bos:
            ids = [bos] + ids
        return ids

    def generate_response(
        self, prompt: str, image_path: Optional[str] = None,
        max_length: int = 100, temperature: float = 0.7,
        top_k: int = 50, top_p: float = 0.9,
        stream: bool = False,
    ) -> Union[str, Generator[str, None, None]]:
        if self.engine is None:
            return "Model not loaded."
        ids = np.asarray([self._encode_prompt(prompt)], np.int32)
        pixel_values = None
        if image_path and self.multimodal:
            pixel_values = self.preprocess_image(image_path)
        elif image_path:
            logger.warning("Image provided but model is not multimodal.")

        kwargs = dict(
            max_new_tokens=max_length,
            do_sample=temperature > 0.001,
            temperature=temperature if temperature > 0.001 else 1.0,
            top_k=top_k if top_k > 0 else 0,
            top_p=top_p if top_p < 1.0 else 1.0,
            eos_token_id=self.config.eos_token_id,
        )
        if stream:
            return self._stream_text(ids, pixel_values, kwargs)
        out = self.engine.generate(ids, pixel_values=pixel_values, **kwargs)
        return self.detokenize(out[0, ids.shape[1]:].tolist())

    def _stream_text(self, ids, pixel_values, kwargs):
        generated: List[int] = []
        for tok in self.engine.stream(ids, pixel_values=pixel_values, **kwargs):
            generated.append(tok)
            yield self.detokenize(generated)

    def _chat_prompt(self, message: str) -> str:
        """The role-formatted prompt of the history and ``message``
        (reference: interface.py:531-548)."""
        parts = [f"{e['role'].capitalize()}: {e['content']}" for e in self.chat_history]
        parts.append(f"User: {message}")
        parts.append("Assistant:")
        return "\n".join(parts)

    def chat(
        self, message: str, image_path: Optional[str] = None,
        max_length: int = 100, temperature: float = 0.7,
        top_k: int = 50, top_p: float = 0.9, stream: bool = False,
    ) -> Union[str, Generator[str, None, None]]:
        """One chat turn with role-formatted history. With ``stream`` it
        yields the reply's text as it grows (``InferenceEngine.stream``) and
        records the turn once the reply is complete."""
        prompt = self._chat_prompt(message)
        if stream:
            return self._stream_turn(message, prompt, image_path, max_length, temperature,
                                     top_k, top_p)
        response = self.generate_response(
            prompt, image_path, max_length, temperature, top_k, top_p)
        self._record_turn(message, response)
        return response

    def _stream_turn(self, message, prompt, image_path, max_length, temperature, top_k,
                     top_p):
        response = ""
        for response in self.generate_response(prompt, image_path, max_length, temperature,
                                               top_k, top_p, stream=True):
            yield response
        self._record_turn(message, response)

    def _record_turn(self, message: str, response: str) -> None:
        self.chat_history.append({"role": "user", "content": message})
        self.chat_history.append({"role": "assistant", "content": response})

    def reset_chat(self) -> None:
        self.chat_history = []

    def launch_web_interface(self) -> None:
        from apertis_llm_torch.inference.ui import launch_ui

        launch_ui(self, port=self.port)


class ApertisInference:
    """Streaming, messages-based chat API (the surface
    ``examples/simple_chat.py`` expects)."""

    def __init__(
        self,
        model_path: str,
        vocab_file: Optional[str] = None,
        multimodal: bool = False,
        device: Optional[str] = None,
        dtype: Optional[str] = None,
        **_compat: Any,
    ):
        self.interface = ApertisInterface(
            model_path=model_path, vocab_file=vocab_file,
            multimodal=multimodal, device=device, dtype=dtype)

    @property
    def config(self) -> Optional[ApertisConfig]:
        return self.interface.config

    @staticmethod
    def _messages_to_prompt(messages: List[Dict[str, str]]) -> str:
        parts = []
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content", "")
            if role == "system":
                parts.append(content)
            else:
                parts.append(f"{role.capitalize()}: {content}")
        parts.append("Assistant:")
        return "\n".join(parts)

    def chat(
        self,
        messages: List[Dict[str, str]],
        image_path: Optional[str] = None,
        stream: bool = False,
        max_new_tokens: int = 100,
        temperature: float = 0.7,
        top_k: int = 50,
        top_p: float = 0.9,
    ) -> Union[str, Generator[str, None, None]]:
        """Generate (or stream cumulative text of) the assistant reply."""
        prompt = self._messages_to_prompt(messages)
        return self.interface.generate_response(
            prompt, image_path=image_path, max_length=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, stream=stream)

    def generate(self, prompt: str, **kwargs) -> str:
        return self.interface.generate_response(prompt, **kwargs)
