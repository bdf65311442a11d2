"""Wordpiece SMILES tokenizer (pure-Python copy of ``spmm_tpu.tokenizer``).

Greedy longest-match wordpiece with ``##`` continuation prefixes over the
300-token vocab (reference SPMM_pretrain.py:19-20), exactly as the JAX
package tokenizes:

  - the raw string is whitespace-split and each word goes through greedy
    wordpiece WHOLE: the literal "[CLS]" the datasets prepend anchors the
    match, after which the molecule tokenizes as ``##``-continuations;
  - words longer than ``max_input_chars_per_word`` become [UNK];
  - ``encode`` adds [CLS] ... [SEP], truncating to ``max_len`` if asked;
  - ``decode``: " ".join(tokens).replace(" ##", "").strip().

The native C++ encoder of the JAX package is not carried over.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP)


def load_vocab(path: str | None = None) -> dict[str, int]:
    """Load the 300-token vocab (token -> id)."""
    if path is None:
        path = os.path.join(_ASSET_DIR, "vocab.json")
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    # also accept a reference-style one-token-per-line file
    with open(path) as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


class SmilesTokenizer:
    """Greedy longest-match wordpiece tokenizer over the SMILES fragment vocab."""

    def __init__(self, vocab: dict[str, int] | None = None,
                 max_input_chars_per_word: int = 250):
        self.vocab = vocab if vocab is not None else load_vocab()
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token_id = self.vocab[PAD]
        self.unk_token_id = self.vocab[UNK]
        self.cls_token_id = self.vocab[CLS]
        self.sep_token_id = self.vocab[SEP]
        self.vocab_size = len(self.vocab)
        # longest vocab entry (sans ## prefix) bounds the greedy search window
        self._max_piece_len = max(
            len(t[2:]) if t.startswith("##") else len(t) for t in self.vocab
        )

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: list[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = min(n, start + self._max_piece_len)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        pieces: list[str] = []
        for word in text.split():
            pieces.extend(self._wordpiece(word))
        return pieces

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> list[int]:
        unk = self.unk_token_id
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    def encode(self, text: str, max_len: int | None = None,
               truncation: bool = False) -> list[int]:
        """[CLS] + pieces + [SEP]; truncate total length to max_len if asked."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation and max_len is not None and len(ids) > max_len - 2:
            ids = ids[: max_len - 2]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def decode(self, ids: Sequence[int], strip_special: bool = True) -> str:
        """ids -> string with '##' continuations merged; [UNK] is kept."""
        tokens = self.convert_ids_to_tokens(ids)
        s = " ".join(tokens).replace(" ##", "").strip()
        if strip_special:
            for t in (PAD, CLS, SEP):
                s = s.replace(t, "")
            s = s.strip()
        return s

    def encode_batch(
        self,
        texts: Sequence[str],
        max_len: int = 100,
        truncation: bool = True,
        buckets: Sequence[int] | None = None,
        drop_leading_cls: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode to (input_ids, attention_mask) int32 arrays, bucket-padded.

        ``drop_leading_cls`` mirrors the reference scripts' ``input_ids[:, 1:]``:
        the string-token [CLS] the datasets prepend plays the role of BOS.
        """
        seqs = [self.encode(t, max_len=max_len, truncation=truncation)
                for t in texts]
        if drop_leading_cls:
            seqs = [s[1:] for s in seqs]
        longest = max(len(s) for s in seqs)
        if buckets:
            pad_len = next((b for b in sorted(buckets) if b >= longest), None)
            if pad_len is None:
                if truncation:
                    pad_len = max(buckets)
                else:
                    # no truncation: grow past the bucket set in aligned
                    # steps rather than cutting [SEP] off
                    pad_len = -(-longest // 32) * 32
            longest = pad_len
        ids = np.zeros((len(seqs), longest), dtype=np.int32)   # 0 == [PAD]
        mask = np.zeros((len(seqs), longest), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:longest]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask


def default_buckets(max_len: int = 100) -> tuple[int, ...]:
    """Static pad buckets: powers-of-two-ish steps up to max_len."""
    b = [16, 24, 32, 48, 64, 80, max_len]
    return tuple(x for x in b if x <= max_len) or (max_len,)
