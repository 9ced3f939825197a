"""CLIP text tokenizers (the port's own copy of view_neti_tpu/tokenizer.py).

The reference relies on HF `CLIPTokenizer.from_pretrained` (reference
training/coach.py:608-612), which requires downloaded vocab files. This
module provides:

  * `ClipBPETokenizer`  — a self-contained CLIP byte-pair-encoding tokenizer
    that loads the standard `vocab.json` + `merges.txt` pair from disk and
    produces ids identical to HF's CLIPTokenizer for the same files.
  * `FallbackTokenizer` — a deterministic hash tokenizer for environments
    with no vocab files (tests / synthetic benchmarks). Stable word -> id
    mapping in the same id space as CLIP (vocab 49408, BOS 49406, EOS 49407).

Both support runtime vocabulary growth for placeholder tokens
(`add_tokens`, reference training/coach.py:326), which the TPU pipeline pairs
with a pre-allocated embedding table (static shapes; see SURVEY.md §7.3.4).
"""
from __future__ import annotations

import gzip
import hashlib
import html
import json
from functools import lru_cache
from pathlib import Path
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

CLIP_VOCAB_SIZE = 49408
CLIP_MAX_LENGTH = 77

# CLIP's exact split pattern needs \p{L}/\p{N} classes, which the stdlib
# `re` lacks. The `regex` module (a transformers dependency) provides them;
# fall back to the closest stdlib approximation when it is absent.
try:
    import regex as _regex
    _CLIP_PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE)
except ImportError:  # pragma: no cover
    _CLIP_PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE | re.UNICODE)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte <-> unicode table (standard construction)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    """Approximate ftfy.fix_text + whitespace_clean on already-sane text
    (HF CLIPTokenizer._tokenize): double html-unescape, NFC normalize,
    collapse whitespace."""
    import unicodedata
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class _TokenizerBase:
    """Shared surface: padding/truncation, added-token registry, helpers."""

    model_max_length = CLIP_MAX_LENGTH

    def __init__(self, base_vocab_size: int = CLIP_VOCAB_SIZE):
        self.bos_token_id = base_vocab_size - 2  # 49406 for CLIP
        self.eos_token_id = base_vocab_size - 1  # 49407 for CLIP
        self.pad_token_id = self.eos_token_id
        self.unk_token_id = self.eos_token_id
        self.base_vocab_size = base_vocab_size
        self.added_tokens: Dict[str, int] = {}

    # -- added (placeholder) tokens -------------------------------------
    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        n_added = 0
        for t in tokens:
            if t in self.added_tokens or self._in_base_vocab(t):
                continue
            self.added_tokens[t] = self.base_vocab_size + len(
                self.added_tokens)
            n_added += 1
        return n_added

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._token_to_id(tokens)
        return [self._token_to_id(t) for t in tokens]

    def __len__(self) -> int:
        return self.base_vocab_size + len(self.added_tokens)

    # -- encoding --------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._encode_text(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def __call__(self, text: Union[str, Sequence[str]], padding: str = None,
                 truncation: bool = False, max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None):
        """HF-compatible call: returns an object with `.input_ids`."""
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        all_ids = []
        for t in texts:
            ids = self.encode(t, add_special_tokens=True)
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_token_id]
            if padding == "max_length":
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            all_ids.append(ids)
        arr = np.asarray(all_ids, dtype=np.int32)

        class _Out:
            pass

        out = _Out()
        out.input_ids = arr
        return out

    # -- subclass hooks ---------------------------------------------------
    def _in_base_vocab(self, token: str) -> bool:
        raise NotImplementedError

    def _token_to_id(self, token: str) -> int:
        raise NotImplementedError

    def _encode_text(self, text: str) -> List[int]:
        raise NotImplementedError

    def _split_with_added(self, text: str) -> List[str]:
        """Split text so added tokens survive as atomic pieces."""
        if not self.added_tokens:
            return [text]
        pattern = "(" + "|".join(
            re.escape(t)
            for t in sorted(self.added_tokens, key=len, reverse=True)) + ")"
        return [p for p in re.split(pattern, text) if p]


class ClipBPETokenizer(_TokenizerBase):
    """CLIP BPE over standard vocab.json/merges.txt files.

    Reference equivalence target: HF CLIPTokenizer (transformers), which is
    what the reference loads (training/coach.py:608-612).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[tuple]):
        super().__init__()
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.base_vocab_size = len(vocab)
        self.bos_token_id = vocab.get("<|startoftext|>", len(vocab) - 2)
        self.eos_token_id = vocab.get("<|endoftext|>", len(vocab) - 1)
        self.pad_token_id = self.eos_token_id
        self.unk_token_id = self.eos_token_id
        self._bpe_cache: Dict[str, str] = {}

    @classmethod
    def from_files(cls, vocab_file: Union[str, Path],
                   merges_file: Union[str, Path]) -> "ClipBPETokenizer":
        vocab_file, merges_file = Path(vocab_file), Path(merges_file)
        opener = gzip.open if vocab_file.suffix == ".gz" else open
        with opener(vocab_file, 'rt') as f:
            vocab = json.load(f)
        opener = gzip.open if merges_file.suffix == ".gz" else open
        with opener(merges_file, 'rt') as f:
            lines = f.read().split("\n")
        # first line is the version header
        merges = [tuple(l.split()) for l in lines[1:] if l and len(
            l.split()) == 2]
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "ClipBPETokenizer":
        path = Path(path)
        vocab = (path / "vocab.json") if (path / "vocab.json").exists() else (
            path / "vocab.json.gz")
        merges = (path / "merges.txt") if (path / "merges.txt").exists() else (
            path / "merges.txt.gz")
        return cls.from_files(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def _in_base_vocab(self, token: str) -> bool:
        return token in self.encoder

    def _token_to_id(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token in self.encoder:
            return self.encoder[token]
        # whole-word lookup with </w> suffix (single-word convenience)
        if token + "</w>" in self.encoder:
            return self.encoder[token + "</w>"]
        return self.unk_token_id

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._split_with_added(text):
            if piece in self.added_tokens:
                ids.append(self.added_tokens[piece])
                continue
            piece = _whitespace_clean(piece).lower()
            for tok in _CLIP_PAT.findall(piece):
                tok = "".join(self.byte_encoder[b]
                              for b in tok.encode("utf-8"))
                ids.extend(
                    self.encoder.get(bpe_tok, self.unk_token_id)
                    for bpe_tok in self._bpe(tok).split(" "))
        return ids


class FallbackTokenizer(_TokenizerBase):
    """Deterministic word-hash tokenizer for vocab-file-free environments.

    Word pieces map to stable ids in [0, 49152) via blake2; the id space,
    special tokens, padding and added-token semantics match CLIP's, so the
    full pipeline (placeholder injection, embedding tables, caching) runs
    unchanged. Not suitable for loading real SD weights (ids won't line up
    with a pretrained embedding table) — supply a tokenizer_path for that.
    """

    def _in_base_vocab(self, token: str) -> bool:
        return not (token.startswith("<") and token.endswith(">"))

    def _hash_word(self, word: str) -> int:
        # leave a 256-id margin below BOS/EOS (49152 for the CLIP id space)
        hash_space = self.base_vocab_size - 256
        h = hashlib.blake2s(word.encode("utf-8"), digest_size=4).digest()
        return int.from_bytes(h, "little") % hash_space

    def _token_to_id(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token.startswith("<") and token.endswith(">"):
            return self.unk_token_id
        return self._hash_word(token.lower())

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._split_with_added(text):
            if piece in self.added_tokens:
                ids.append(self.added_tokens[piece])
                continue
            piece = _whitespace_clean(piece).lower()
            for tok in _CLIP_PAT.findall(piece):
                ids.append(self._hash_word(tok))
        return ids
