"""WordPiece tokenizer for the reference's `mimic_wordpiece.json` (an HF
tokenizers asset), the pure-Python path of `ecamp_tpu/data/tokenizer.py`.

Pipeline, from the asset's own config:
  added-token split ([PAD]/[UNK]/[CLS]/[MASK]/[SEP], unnormalized match)
  -> normalizer: Lowercase + NFKD + StripAccents
  -> pre-tokenizer: Whitespace (\\w+|[^\\w\\s]+) then Digits(grouped)
  -> WordPiece greedy longest-match, '##' continuation, [UNK], 100-char cap
  -> truncation + fixed-length padding (pretrain_datasets.py:134-137)

The JAX package's C++ fast path (`ecamp_tpu/data/native.py`) is host code
with the same output on ASCII text and is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WHITESPACE_RE = re.compile(r"\w+|[^\w\s]+", re.UNICODE)
_DIGIT_SPLIT_RE = re.compile(r"\d+|\D+", re.UNICODE)


@dataclass
class Encoding:
    ids: np.ndarray             # (L,) int32
    attention_mask: np.ndarray  # (L,) int32
    type_ids: np.ndarray        # (L,) int32


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100,
                 special_tokens: Sequence[str] = ("[PAD]", "[UNK]", "[CLS]",
                                                  "[MASK]", "[SEP]"),
                 pad_id: int = 0):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word
        self.special_tokens = [t for t in special_tokens if t in vocab]
        self.pad_id = pad_id
        self._special_re = None
        if self.special_tokens:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in self.special_tokens) + ")")

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
        model = cfg["model"]
        specials = [t["content"] for t in cfg.get("added_tokens", [])]
        return cls(model["vocab"], unk_token=model.get("unk_token", "[UNK]"),
                   continuing_subword_prefix=model.get(
                       "continuing_subword_prefix", "##"),
                   max_input_chars_per_word=model.get(
                       "max_input_chars_per_word", 100),
                   special_tokens=specials or ("[PAD]", "[UNK]", "[CLS]",
                                               "[MASK]", "[SEP]"))

    @staticmethod
    def normalize(text: str) -> str:
        text = unicodedata.normalize("NFKD", text.lower())
        return "".join(c for c in text if unicodedata.category(c) != "Mn")

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        words: List[str] = []
        for m in _WHITESPACE_RE.finditer(text):
            piece = m.group(0)
            if any(c.isdigit() for c in piece) and not piece.isdigit():
                words.extend(_DIGIT_SPLIT_RE.findall(piece))
            else:
                words.append(piece)
        return words

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    def tokenize(self, text: str) -> List[str]:
        segments: List[Tuple[str, bool]] = [(text, False)]
        if self._special_re is not None:
            segments = [(part, part in self.special_tokens)
                        for part in self._special_re.split(text) if part]
        tokens: List[str] = []
        for seg, is_special in segments:
            if is_special:
                tokens.append(seg)
                continue
            for word in self.pre_tokenize(self.normalize(seg)):
                tokens.extend(self.wordpiece(word))
        return tokens

    def encode(self, text: str, max_length: Optional[int] = None,
               pad_to: Optional[int] = None) -> Encoding:
        tokens = self.tokenize(text)
        if max_length is not None:
            tokens = tokens[:max_length]
        ids = [self.vocab.get(t, self.vocab[self.unk_token]) for t in tokens]
        n = len(ids)
        L = pad_to if pad_to is not None else n
        out = np.full((L,), self.pad_id, dtype=np.int32)
        out[:n] = ids
        attn = np.zeros((L,), dtype=np.int32)
        attn[:n] = 1
        return Encoding(ids=out, attention_mask=attn,
                        type_ids=np.zeros((L,), dtype=np.int32))
