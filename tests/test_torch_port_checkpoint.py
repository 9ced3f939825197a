"""checkpoint.apply_learned_embeds_to_table against the JAX package's: the
same table, rows and FallbackTokenizer(base_vocab_size=512) of each
package give the same ids and rows, leave the input table untouched, and
raise the same ValueError on a vocabulary overflow."""
import numpy as np
import pytest

from view_neti_tpu.checkpoint import apply_learned_embeds_to_table as japply
from view_neti_tpu.tokenizer import FallbackTokenizer as JTok

from view_neti_tpu_torch.checkpoint import apply_learned_embeds_to_table
from view_neti_tpu_torch.tokenizer import FallbackTokenizer

D = 16


def _table(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, D).astype(np.float32)


def _embeds(tokens, seed=1):
    rng = np.random.RandomState(seed)
    return {t: rng.randn(D).astype(np.float32) for t in tokens}


def _both(table, embeds, added=()):
    """(JAX result, port result, JAX tokenizer, port tokenizer), each
    tokenizer holding `added` first."""
    jtok, ttok = JTok(base_vocab_size=512), FallbackTokenizer(
        base_vocab_size=512)
    for tok in (jtok, ttok):
        tok.add_tokens(list(added))
    before = table.copy()
    want = japply(table, embeds, jtok)
    got = apply_learned_embeds_to_table(table, embeds, ttok)
    np.testing.assert_array_equal(table, before)
    return want, got, jtok, ttok


@pytest.mark.parametrize("tokens,added", [
    (["<view>"], []),
    (["<view>", "<obj>", "<v_1>"], []),
    # already in the vocabulary: an added token, and a base-vocab word
    (["<obj>", "<view>"], ["<view>", "<obj>"]),
    (["cat", "<view>"], []),
])
def test_ids_and_rows_equal_the_jax_functions(tokens, added):
    table = _table(640)
    embeds = _embeds(tokens)
    (wtable, wids), (gtable, gids), jtok, ttok = _both(table, embeds, added)
    assert gids == wids and len(gids) == len(tokens)
    assert gids == [ttok.convert_tokens_to_ids(t) for t in tokens]
    assert gtable.dtype == wtable.dtype == np.float32
    np.testing.assert_array_equal(gtable, wtable)
    for t, i in zip(tokens, gids):
        np.testing.assert_array_equal(gtable[i], embeds[t])
    untouched = np.setdiff1d(np.arange(len(table)), gids)
    np.testing.assert_array_equal(gtable[untouched], table[untouched])
    assert ttok.added_tokens == jtok.added_tokens
    assert gtable is not table


def test_rows_are_cast_to_float32_as_the_jax_functions():
    table = _table(520)
    embeds = {"<a>": np.arange(D, dtype=np.float64) / 3}
    (wtable, wids), (gtable, gids), _, _ = _both(table, embeds)
    assert gids == wids == [512]
    np.testing.assert_array_equal(gtable, wtable)


@pytest.mark.parametrize("rows", [512, 514])
def test_overflow_raises_the_jax_functions_error(rows):
    table = _table(rows)
    embeds = _embeds(["<a>", "<b>", "<c>"])
    with pytest.raises(ValueError) as want:
        japply(table, embeds, JTok(base_vocab_size=512))
    before = table.copy()
    with pytest.raises(ValueError) as got:
        apply_learned_embeds_to_table(table, embeds,
                                      FallbackTokenizer(base_vocab_size=512))
    assert str(got.value) == str(want.value)
    assert str(got.value) == (f"vocab overflow loading <{'ac'[rows > 512]}>:"
                              f" id {rows} >= {rows}")
    np.testing.assert_array_equal(table, before)
