"""The port's CLIP split without the `regex` module: the scanner over
unicodedata's categories splits every assigned code point as the `regex`
pattern of the JAX package does, and a prompt with such a character gets
the JAX tokenizer's ids when the port falls back to it."""
import sys
import unicodedata

import numpy as np
import pytest
import regex

from view_neti_tpu import tokenizer as jtok
from view_neti_tpu_torch import tokenizer as ttok

PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)

PLANES = [(lo, lo + 0x10000) for lo in range(0, 0x110000, 0x10000)]


@pytest.mark.parametrize("lo,hi", PLANES[:3] + [(PLANES[3][0], 0x110000)],
                         ids=["plane0", "plane1", "plane2", "planes3-16"])
def test_scanner_splits_every_assigned_code_point_as_regex(lo, hi):
    """"a"+ch+"b 1"+ch+"2" and a contraction "'"+ch+"e" for every code
    point whose category is not Cn."""
    bad = []
    for cp in range(lo, hi):
        ch = chr(cp)
        if unicodedata.category(ch) == "Cn":
            continue
        for text in ("a" + ch + "b 1" + ch + "2", "'" + ch + "e x" + ch):
            want = PATTERN.findall(text)
            if ttok._scan_split(text) != want:
                bad.append((hex(cp), text, want))
    assert not bad, bad[:10]


def test_scanner_on_specials_and_contractions():
    text = ("<|startoftext|>it'S ſ 'll x²³ a_b -- ä1.5€ "
            "<|ENDOFTEXT|>\x1c\x1dq　z")
    assert ttok._scan_split(text) == PATTERN.findall(text)


def test_fallback_ids_equal_the_jax_tokenizers(monkeypatch):
    """With the scanner forced, the port's ids of a prompt with a
    superscript equal the JAX tokenizer's (which uses `regex`); the old
    stdlib pattern kept "x²" whole."""
    monkeypatch.setattr(ttok, "_clip_split", ttok._scan_split)
    assert "regex" in sys.modules
    prompt = "a photo of x² <view_0_45_1> and  <obj>'s 3D"
    ids = []
    for mod in (jtok, ttok):
        tok = mod.FallbackTokenizer()
        tok.add_tokens(["<view_0_45_1>", "<obj>"])
        ids.append(tok(prompt, padding="max_length", max_length=77,
                       truncation=True).input_ids)
    np.testing.assert_array_equal(ids[1], ids[0])
    assert ttok._scan_split("x²") == ["x", "²"]
