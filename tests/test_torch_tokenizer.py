"""The port's CLIP BPE tokenizer against the JAX package's, which splits
text with the ``regex`` module: the same ids on hypothesis strings drawn from
letters, numerals of every kind (Nd, No, Nl), marks, punctuation, symbols,
HTML entities, contractions in both cases, the two special tokens and text
past 77 tokens, on a synthetic CLIP-shaped vocab (byte symbols, merges,
special tokens at 49406 / 49407)."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from image_editing_framework_torch.models import tokenizer as port_tok
from image_editing_framework_tpu.models import tokenizer as jax_tok
from torch_port_helpers import chip_smoke

WORDS = "a photo of the cat dog sitting on grass house mountain at fall café naïve".split()
VOCAB, MERGES = chip_smoke().synthetic_clip_vocab(WORDS)
PORT = port_tok.CLIPTokenizer(VOCAB, MERGES)
JAX = jax_tok.CLIPTokenizer(VOCAB, MERGES)

FRAGMENTS = st.one_of(
    st.characters(categories=["Lu", "Ll", "Lt", "Lm", "Lo"]),
    st.characters(categories=["Nd", "No", "Nl"]),
    st.characters(categories=["Mn", "Mc", "Me"]),
    st.characters(categories=["Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"]),
    st.characters(categories=["Sm", "Sc", "Sk", "So"]),
    st.characters(categories=["Zs", "Cc"]),
    st.sampled_from(["&amp;", "&lt;", "&gt;", "&quot;", "&#39;", "&amp;amp;", "&lt;|endoftext|&gt;", "&nbsp;"]),
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'T", "'RE", "'Ve", "'M", "'LL", "'D",
                     "ſ", "'ſ", "ͅ", "²", "Ⅻ", "Ⅲ"]),
    st.sampled_from(["<|startoftext|>", "<|endoftext|>", "<|STARTOFTEXT|>", "<|EndOfText|>", "<|startoftext",
                     "<|"]),
    st.sampled_from(WORDS + [w.upper() for w in WORDS] + [" ", "  ", "\t", "\n"]),
)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(FRAGMENTS, max_size=40).map("".join))
def test_same_pieces_and_ids_as_jax(text):
    cleaned = jax_tok._clean(text)
    assert port_tok._clean(text) == cleaned
    assert port_tok._pretokenize(cleaned) == jax_tok._PAT.findall(cleaned)
    assert PORT.encode(text) == JAX.encode(text)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(WORDS + ["!!", "42", "'s"]), min_size=80, max_size=120).map(" ".join))
def test_text_past_77_tokens_is_truncated_as_in_jax(text):
    ids = PORT.encode(text)
    assert ids == JAX.encode(text)
    assert len(ids) == 77 and ids[0] == PORT.bos_id and ids[-1] == PORT.eos_id
    np.testing.assert_array_equal(PORT.encode_padded([text, "a cat"]), JAX.encode_padded([text, "a cat"]))


def test_merges_make_words_whole_and_decode_strips_the_marker():
    ids = PORT.encode("A photo of the CAT sitting on grass")
    assert ids == [49406] + [VOCAB[w + "</w>"] for w in "a photo of the cat sitting on grass".split()] + [49407]
    assert PORT.decode_token(VOCAB["cat</w>"]) == JAX.decode_token(VOCAB["cat</w>"]) == "cat"
    assert [PORT.decode_token(i) for i in ids] == [JAX.decode_token(i) for i in ids]
    assert PORT.decode_token(10**6) == ""


@pytest.mark.parametrize("text", ["", "   ", "ͅ", "<|startoftext|><|endoftext|>", "x'sy !'s ²Ⅻ3",
                                  "café naïve 日本語 \U0001f642 &amp;amp; &lt;b&gt;"])
def test_edge_cases_match_jax(text):
    assert PORT.encode(text) == JAX.encode(text)


def test_from_dir_reads_the_checkpoint_files(tmp_path):
    chip_smoke().write_tokenizer(str(tmp_path), VOCAB, MERGES)
    port, jax = port_tok.CLIPTokenizer.from_dir(str(tmp_path)), jax_tok.CLIPTokenizer.from_dir(str(tmp_path))
    assert port.vocab == VOCAB and port.ranks == jax.ranks and len(port.vocab) == 49408
    assert (port.bos_id, port.eos_id) == (49406, 49407)
    prompts = ["a cat sitting on the grass", "a dog sitting on the grass, café n°2"]
    np.testing.assert_array_equal(port.encode_padded(prompts), jax.encode_padded(prompts))
