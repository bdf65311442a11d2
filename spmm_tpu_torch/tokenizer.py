"""Wordpiece SMILES tokenizer (the port's copy of ``spmm_tpu.tokenizer``).

Greedy longest-match wordpiece with ``##`` continuation prefixes over the
300-token vocab (reference SPMM_pretrain.py:19-20), exactly as the JAX
package tokenizes:

  - the raw string is whitespace-split and each word goes through greedy
    wordpiece WHOLE: the literal "[CLS]" the datasets prepend anchors the
    match, after which the molecule tokenizes as ``##``-continuations;
  - words longer than ``max_input_chars_per_word`` become [UNK];
  - ``encode`` adds [CLS] ... [SEP], truncating to ``max_len`` if asked;
  - ``decode``: " ".join(tokens).replace(" ##", "").strip().

``encode_batch`` runs the native C++ encoder when it truncates, as JAX's
does (spmm_tpu/tokenizer.py:155-187): ``NativeWordpiece``, a ctypes
binding of the port's copy of the JAX package's wordpiece
(``csrc/wordpiece.cpp``), which ``ops._host_build`` compiles with the host
C++ compiler at the first native encode (never at import) into
``build/spmm_tpu_torch/``.  Its output is the Python path's; where no
compiler exists (``native_available()`` is False) the Python path runs.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Iterable, Optional, Sequence

import numpy as np

from spmm_tpu_torch.utils.spans import span

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
    """Greedy longest-match wordpiece tokenizer over the SMILES fragment
    vocab.  ``native=False`` keeps ``encode_batch`` on the Python path."""

    def __init__(self, vocab: dict[str, int] | None = None,
                 max_input_chars_per_word: int = 250, native: bool = True):
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
        self._want_native = native
        self._native: Optional[NativeWordpiece] = None

    def native_encoder(self) -> Optional["NativeWordpiece"]:
        """The native encoder over this vocab, built at the first call;
        None with ``native=False`` or where it cannot be built."""
        if self._want_native and self._native is None:
            self._want_native = False          # one attempt
            if native_available():
                self._native = NativeWordpiece(
                    self.vocab,
                    max_input_chars_per_word=self.max_input_chars_per_word)
        return self._native

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
        with span("spmm.detokenize"):
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
        With truncation the native encoder runs where it is built, with the
        Python path's output (spmm_tpu/tokenizer.py:174-193).
        """
        native = (self.native_encoder() if truncation and max_len is not None
                  else None)
        if native is not None:
            raw, lens = native.encode_batch_padded(list(texts), max_len)
            if drop_leading_cls:
                raw, lens = raw[:, 1:], lens - 1
            longest = int(lens.max())
            if buckets:
                longest = next((b for b in sorted(buckets) if b >= longest),
                               max(buckets))
            if longest > raw.shape[1]:
                # a bucket wider than the raw buffer: pad zeros
                raw = np.pad(raw, [(0, 0), (0, longest - raw.shape[1])])
            ids = np.ascontiguousarray(raw[:, :longest])
            mask = (np.arange(longest)[None, :]
                    < lens[:, None]).astype(np.int32)
            return ids * mask, mask
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


# --------------------------------------------------------------------------- #
# the native encoder (csrc/wordpiece.cpp)
# --------------------------------------------------------------------------- #

_native_lock = threading.Lock()
_native_build: dict = {}        # "path" or "error", after the one attempt


def native_library() -> Optional[str]:
    """Path of the built wordpiece library: built by ``ops._host_build``
    at the first call (one attempt a process); None where it cannot be
    built (no compiler), the reason in ``native_build_error()``."""
    from spmm_tpu_torch.ops._host_build import build_host

    with _native_lock:
        if not _native_build:
            try:
                _native_build["path"] = str(build_host("wordpiece"))
            except (RuntimeError, OSError) as exc:
                _native_build["error"] = str(exc)
    return _native_build.get("path")


def native_build_error() -> Optional[str]:
    return _native_build.get("error")


def native_available() -> bool:
    """Whether the native encoder is built (building it if not yet tried)."""
    return native_library() is not None


class NativeWordpiece:
    """ctypes binding of ``csrc/wordpiece.cpp`` (JAX's ``NativeWordpiece``,
    spmm_tpu/tokenizer.py:223-296), with ``SmilesTokenizer.encode`` /
    ``encode_batch``'s semantics.  ``lib_path`` defaults to the port's
    build (``native_library``)."""

    def __init__(self, vocab: dict[str, int] | None = None,
                 lib_path: str | None = None,
                 max_input_chars_per_word: int = 250):
        path = lib_path or native_library()
        if path is None:
            raise RuntimeError(f"the native wordpiece did not build: "
                               f"{native_build_error()}")
        self._lib = lib = ctypes.CDLL(path)
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int32, ctypes.c_int32]
        lib.wp_free.restype = None
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode.restype = ctypes.c_int32
        lib.wp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.wp_encode_batch.restype = None
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        vocab = vocab if vocab is not None else load_vocab()
        tokens = sorted(vocab, key=vocab.get)
        arr = (ctypes.c_char_p * len(tokens))(
            *[t.encode("utf-8") for t in tokens])
        self._handle = lib.wp_create(arr, len(tokens),
                                     max_input_chars_per_word)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_free(self._handle)
            self._handle = None

    def encode(self, text: str, max_len: int | None = None,
               truncation: bool = False) -> list[int]:
        cap = 4096
        out = (ctypes.c_int32 * cap)()
        n = self._lib.wp_encode(
            self._handle, text.encode("utf-8"),
            1 if (truncation and max_len) else 0, max_len or 0, out, cap)
        if n < 0:
            raise ValueError("sequence too long for native encode buffer")
        return list(out[:n])

    def encode_batch_padded(self, texts: Sequence[str], max_len: int
                            ) -> tuple[np.ndarray, np.ndarray]:
        """[n, max_len] ids (0-padded, truncated) and the lengths."""
        n = len(texts)
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
        ids = np.zeros((n, max_len), np.int32)
        lens = np.zeros((n,), np.int32)
        self._lib.wp_encode_batch(
            self._handle, arr, n, 1, max_len,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return ids, lens
