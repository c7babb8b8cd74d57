"""The port's tokenizer, templates and config against the JAX package.

The port splits text without the ``regex`` module (a scanner over
``unicodedata``); it must give the same ids as ``jcf_tpu.tokenizer``
(which uses ``regex``) on the golden strings of ``tests/test_tokenizer.py``,
on every prompt pattern x a list of class names, and on a derandomized
hypothesis corpus of Unicode text (letters of many scripts, ``²½`` and
other numbers that are not digits, combining marks, CJK, U+001C-U+001F,
which Python's ``re`` counts as whitespace and ``regex`` does not, the
long s and U+0345, which match by case folding). Also: the vocab file is
a byte-identical copy, and the config defaults are the JAX package's."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import jcf_tpu.config as jconfig
import jcf_tpu.data.templates as jtemplates
from jcf_tpu.tokenizer import get_tokenizer as j_get_tokenizer
from jcf_tpu.tokenizer import tokenize as j_tokenize
from jcf_tpu.tokenizer.bpe import default_vocab_path as j_vocab_path
from test_tokenizer import GOLDEN
import torch

import jcf_tpu_torch.config as tconfig
import jcf_tpu_torch.data.templates as ttemplates
from jcf_tpu_torch.tokenizer import EOT_TOKEN, SOT_TOKEN, CONTEXT_LENGTH, get_tokenizer, tokenize
from jcf_tpu_torch.tokenizer.bpe import default_vocab_path

torch.set_num_threads(1)

CLASS_NAMES = [
    "Animal_Giant_panda", "Animal_Bald_eagle", "Caltech-101_Faces_easy", "Food_Apple_pie",
    "Thu-dog_Shih-Tzu", "Stanford-Cars_2012_BMW_M3_coupe", "Food_Crème_brûlée",
    "Animal_Saint_Bernard's", "Thing_iPod", "Food_Bánh_mì", "Thing_T-shirt", "X",
]
# an alphabet that reaches every branch of the scanner; the categories
# leave out unassigned code points (Cn), since ``regex`` may ship a newer
# Unicode version than the interpreter's database
_SPECIAL_CHARS = "\u00b2\u00bd\u09f4\u0345\u017f\x1c\x1d\x1e\x1f\t\n\xa0\u3000 '<|>_-.,!&;#"
_ALPHABET = st.one_of(
    st.characters(codec="utf-8", categories=["L", "M", "N", "P", "S", "Zs"]),
    st.sampled_from(list(_SPECIAL_CHARS)),
    st.sampled_from(list("aAsStTrReEvVmMlLdD ")),
)
_PIECES = st.one_of(
    st.text(_ALPHABET, max_size=12),
    st.sampled_from(["<|startoftext|>", "<|endoftext|>", "<|\u017ftartoftext|>", "<|ENDOFTEXT|>",
                     "'s", "'S", "'\u017f", "'ll", "'LL", "'Re", "'ve", "'m", "'d", "'t",
                     "&amp;", "&#39;", "café"]),
)


def test_vocab_is_a_byte_identical_copy():
    assert os.path.basename(default_vocab_path()) == os.path.basename(j_vocab_path())
    assert filecmp.cmp(default_vocab_path(), j_vocab_path(), shallow=False)


def test_vocab_structure():
    tok = get_tokenizer()
    assert tok.vocab_size == 49408
    assert tok.sot_token == SOT_TOKEN == 49406 and tok.eot_token == EOT_TOKEN == 49407
    assert tok.encoder == j_get_tokenizer().encoder


@pytest.mark.parametrize("text,expected", GOLDEN.items(), ids=list(map(repr, GOLDEN)))
def test_golden_encode(text, expected):
    assert get_tokenizer().encode(text) == expected


@pytest.mark.parametrize("pattern", jtemplates.TEMPLATE_PATTERNS)
def test_templates_tokenize_as_jax(pattern):
    texts = [pattern.format(jtemplates._clean_classname(n)) for n in CLASS_NAMES]
    np.testing.assert_array_equal(tokenize(texts), j_tokenize(texts))


def test_tokenize_padding_truncation_and_errors():
    long_text = "cat " * 100
    np.testing.assert_array_equal(tokenize(long_text, truncate=True),
                                  j_tokenize(long_text, truncate=True))
    with pytest.raises(RuntimeError):
        tokenize(long_text)
    arr = tokenize(["a photo of a cat", ""])
    assert arr.shape == (2, CONTEXT_LENGTH) and arr.dtype == np.int32
    np.testing.assert_array_equal(arr, j_tokenize(["a photo of a cat", ""]))


@settings(max_examples=300, derandomize=True, deadline=None, database=None)
@given(st.lists(_PIECES, max_size=8).map("".join))
@example("\x1c a\x1fb \u0345x\u0345 \u00b2\u00bd\u09f4 \u6f22\u5b57 \u00e9")
@example("<|\u017ftartoftext|>it'\u017f ok'S <|endoftext|>")
def test_unicode_corpus_encodes_as_jax(text):
    assert get_tokenizer().encode(text) == j_get_tokenizer().encode(text)


def test_templates_match_jax(tmp_path):
    assert ttemplates.TEMPLATE_PATTERNS == jtemplates.TEMPLATE_PATTERNS
    for n in CLASS_NAMES:
        assert ttemplates._clean_classname(n) == jtemplates._clean_classname(n)
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(f"{n} {i}\n" for i, n in enumerate(CLASS_NAMES)) + "\n")
    captions = tmp_path / "captions.txt"
    captions.write_text("a giant panda eating bamboo.\nan eagle in flight.\n")
    for out, mod in (("t", ttemplates), ("j", jtemplates)):
        mod.synthesize_templates(str(classes), str(tmp_path / out), str(captions))
    for bank in range(1, 9):
        name = f"text_template{bank}.txt"
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert (ttemplates.load_class_templates(str(tmp_path / "t"))
            == jtemplates.load_class_templates(str(tmp_path / "j")))


@pytest.mark.parametrize("make", ["PipelineConfig", "perf_preset"])
def test_config_defaults_match_jax(make):
    """Field by field: every field the port keeps has the JAX default, in
    the default config and in the perf preset."""
    t, j = getattr(tconfig, make)(), getattr(jconfig, make)()
    for section in ("data", "runtime", "lora", "stage1"):
        if section in ("lora", "stage1"):  # ported whole
            assert ([f.name for f in dataclasses.fields(getattr(t, section))]
                    == [f.name for f in dataclasses.fields(getattr(j, section))]), section
        for f in dataclasses.fields(getattr(t, section)):
            assert getattr(getattr(t, section), f.name) == getattr(getattr(j, section), f.name), \
                (section, f.name)
