"""Training datasets: JSONL pretrain + instruction fine-tune, numpy-native.

A copy of ``apertis_llm_tpu/training/datasets.py`` (the reference:
src/training/pipeline.py:75-202, 204-385): whitespace manual tokenisation
with unk/out-of-bounds remapping, pad/truncate to max_length, labels with
pads masked to -100, and prompt-token masking with BOS/EOS heuristics for the
fine-tune path. Items are numpy arrays assembled into whole batches by
:class:`BatchLoader`, which shuffles as the JAX copy does, so both packages
see the same batches.

Left out: the optional C++ pretokenizer (a faster route to the same ids) and
multimodal items, which raise ``NotImplementedError`` until the image prefix
is ported (ROADMAP.md, module 3).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _load_jsonl(data_path: str, required_fields: tuple) -> List[Dict]:
    data = []
    with open(data_path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                item = json.loads(line)
            except json.JSONDecodeError as e:
                logger.warning("Skipping line %d in %s: %s", i + 1, data_path, e)
                continue
            if any(field not in item for field in required_fields):
                logger.warning("Skipping line %d in %s: missing %s",
                               i + 1, data_path, required_fields)
                continue
            data.append(item)
    return data


class ApertisPretrainDataset:
    """JSONL ``{"text": ...}`` with whitespace manual tokenisation."""

    def __init__(
        self,
        data_path: str,
        vocab_dict: Optional[Dict[str, int]] = None,
        model_config_vocab_size: int = 0,
        max_length: int = 512,
        multimodal: bool = False,
        image_dir: Optional[str] = None,
        image_size: int = 224,
        pad_token_id: int = 0,
        unk_token_id: int = 3,
        bos_token_id: int = 1,
        eos_token_id: int = 2,
        hf_tokenizer: Any = None,
    ):
        if vocab_dict is None and hf_tokenizer is None:
            raise ValueError("need vocab_dict or hf_tokenizer")
        if multimodal:
            raise NotImplementedError(
                "multimodal pre-training is not ported to PyTorch yet (see ROADMAP.md)")
        self.data = _load_jsonl(data_path, ("text",))
        self.vocab = vocab_dict
        # TPU-repo extension: subword pre-training via an HF tokenizer
        # (the reference pretrain path is whitespace-only). Each document
        # is encoded without special tokens and terminated with EOS.
        self.hf_tokenizer = hf_tokenizer
        self.model_vocab_size = model_config_vocab_size
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.unk_token_id = unk_token_id
        self.eos_token_id = eos_token_id

    def __len__(self) -> int:
        return len(self.data)

    def _tokenize(self, text) -> List[int]:
        if self.hf_tokenizer is not None and isinstance(text, str):
            ids = self.hf_tokenizer.encode(text, add_special_tokens=False)
            ids.append(self.eos_token_id)
            return [self.unk_token_id if t >= self.model_vocab_size else t
                    for t in ids]
        if isinstance(text, str):
            raw = text.split()
        elif isinstance(text, list):
            raw = text
        else:
            logger.warning("Unexpected text type %s; treating as empty", type(text))
            raw = []
        ids = []
        for tok in raw:
            if isinstance(tok, int):
                tid = tok
            else:
                tid = self.vocab.get(str(tok), self.vocab.get("<unk>", self.unk_token_id))
            ids.append(self.unk_token_id if tid >= self.model_vocab_size else tid)
        return ids

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.data[idx]
        ids = self._tokenize(item.get("text", ""))[: self.max_length]
        ids = ids + [self.pad_token_id] * (self.max_length - len(ids))
        input_ids = np.asarray(ids, np.int32)
        attention_mask = (input_ids != self.pad_token_id).astype(np.int32)
        labels = np.where(input_ids == self.pad_token_id, -100, input_ids).astype(np.int32)
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "labels": labels}


class ApertisFineTuneDataset:
    """JSONL ``{"instruction", "output"}`` with prompt-template masking."""

    def __init__(
        self,
        data_path: str,
        tokenizer: Any,  # HF tokenizer object OR manual vocab dict
        max_length: int = 512,
        prompt_template: str = "User: {instruction}\nAssistant: {output}",
        is_hf_tokenizer: bool = False,
        model_config_vocab_size: Optional[int] = None,
        model_config_eos_token_id: Optional[int] = None,
        model_config_pad_token_id: Optional[int] = None,
        model_config_unk_token_id: Optional[int] = None,
        model_config_bos_token_id: Optional[int] = None,
    ):
        self.data = _load_jsonl(data_path, ("instruction", "output"))
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.prompt_template = prompt_template
        self.is_hf = is_hf_tokenizer
        if self.is_hf:
            self.pad_token_id = tokenizer.pad_token_id
            self.eos_token_id = tokenizer.eos_token_id
            if self.pad_token_id is None and self.eos_token_id is not None:
                self.pad_token_id = self.eos_token_id
            if self.pad_token_id is None or self.eos_token_id is None:
                raise ValueError("HF tokenizer needs pad/eos token ids for fine-tuning")
        else:
            if not isinstance(tokenizer, dict) or model_config_vocab_size is None:
                raise ValueError("Manual-vocab fine-tuning needs vocab dict + model ids")
            self.vocab = tokenizer
            self.model_vocab_size = model_config_vocab_size
            self.eos_token_id = model_config_eos_token_id
            self.pad_token_id = model_config_pad_token_id
            self.unk_token_id = model_config_unk_token_id

    def __len__(self) -> int:
        return len(self.data)

    def _manual_tokenize(self, text: str) -> List[int]:
        ids = []
        for word in text.split():
            tid = self.vocab.get(word, self.vocab.get("<unk>", self.unk_token_id))
            ids.append(self.unk_token_id if tid >= self.model_vocab_size else tid)
        return ids

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.data[idx]
        instruction = item.get("instruction", "")
        output_text = item.get("output", "")
        if "{instruction}" in self.prompt_template and "{output}" in self.prompt_template:
            full_text = self.prompt_template.format(
                instruction=instruction, output=output_text)
            prompt_part = self.prompt_template.format(
                instruction=instruction, output="").rstrip()
        else:
            full_text = f"User: {instruction}\nAssistant: {output_text}"
            prompt_part = f"User: {instruction}\nAssistant:".rstrip()

        if self.is_hf:
            tok = self.tokenizer
            full_with_eos = full_text + (tok.eos_token or "")
            prompt_tokens = tok(prompt_part, add_special_tokens=False,
                                truncation=False)["input_ids"]
            full_tokenized = tok(full_with_eos, add_special_tokens=True,
                                 truncation=True,
                                 max_length=self.max_length)["input_ids"]
            prompt_with_specials = tok(prompt_part, add_special_tokens=True,
                                       truncation=True,
                                       max_length=self.max_length)["input_ids"]
            if full_tokenized[:len(prompt_with_specials)] == prompt_with_specials:
                len_prompt = len(prompt_with_specials)
            else:
                len_prompt = len(prompt_tokens)
                if (tok.bos_token_id is not None and full_tokenized
                        and full_tokenized[0] == tok.bos_token_id):
                    len_prompt += 1
        else:
            prompt_tokens = self._manual_tokenize(prompt_part)
            output_tokens = self._manual_tokenize(output_text)
            raw = prompt_tokens + output_tokens + [self.eos_token_id]
            if len(raw) > self.max_length:
                full_tokenized = raw[: self.max_length - 1] + [self.eos_token_id]
            else:
                full_tokenized = raw
            len_prompt = len(prompt_tokens)

        seq_len = len(full_tokenized)
        ids = full_tokenized + [self.pad_token_id] * (self.max_length - seq_len)
        input_ids = np.asarray(ids, np.int32)
        attention_mask = (input_ids != self.pad_token_id).astype(np.int32)
        labels = input_ids.astype(np.int32).copy()
        labels[: min(len_prompt, seq_len)] = -100
        labels[input_ids == self.pad_token_id] = -100
        # Keep a trailing EOS supervised when it belongs to the target.
        if min(len_prompt, seq_len) < seq_len and full_tokenized[-1] == self.eos_token_id:
            labels[seq_len - 1] = full_tokenized[-1]
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "labels": labels}


class BatchLoader:
    """Shuffling batch iterator producing stacked numpy batches.

    The JAX copy's order: a permutation by ``default_rng(seed + epoch)``
    when shuffling, whole batches, the last one dropped when short and
    ``drop_last``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            items = [self.dataset[int(i)] for i in idx]
            keys = items[0].keys()
            yield {k: np.stack([it[k] for it in items]) for k in keys}
