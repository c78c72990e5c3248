"""The port's vendored tokenizers (``reptext_tpu_torch/text``) against the JAX
package's, on the synthetic vocabularies of ``tests/test_tokenizers.py``.

CLIP: the same vocab.json / merges.txt through both byte-BPEs; the port splits
words with ``unicodedata`` categories where the JAX package uses the
``regex`` module, so the split is also held against the JAX pattern on
Arabic, Latin, digits, marks, contractions and the special tokens. T5: the same
serialized ModelProto through both wire readers and unigram Viterbi encoders.
The CLI's ``_tokenize`` reads a checkpoint directory's files as the JAX CLI's
does; ids must be equal, exactly.
"""

import numpy as np
import pytest

from reptext_tpu.text import CLIPBPETokenizer as JCLIP
from reptext_tpu.text import SentencePieceUnigram as JSPM
from reptext_tpu.text.clip_bpe import _PAT, _basic_clean
from reptext_tpu.text.spm import parse_model_proto as j_parse
from reptext_tpu_torch.io import synthetic
from reptext_tpu_torch.text import CLIPBPETokenizer, SentencePieceUnigram, pad_to_common_length
from reptext_tpu_torch.text.clip_bpe import split_words
from reptext_tpu_torch.text.spm import normalize, parse_model_proto

from torch_port_util import TINY_PIECES, serialize_model_proto, tiny_clip_files, write_tokenizer_dirs

PROMPTS = [
    "hello world",
    "Hello, WORLD!  multiple   spaces",
    'a sign that says "hello"',
    "hello-world 123",
    "café naïve",
    "مرحبا بالعالم",
    "سوق الذهب، مفتوح ٢٤ ساعة",
    "a street sign in city, 'مرحبا', filmfotos, film grain, reversal film photography",
    "hello 你好 world",
    "",
]
SPLITS = PROMPTS + [
    "it's the world's 12th'sign",          # contractions inside words and after digits
    "<|startoftext|>hi<|endoftext|>!!",     # the special tokens and a punctuation run
    "مَرْحَبًا بِكُمْ",                          # Arabic with harakat (marks split the letters)
    "x²+y³=z ½ ⅔ Ⅻ ١٢٣",                    # \p{N} beyond ASCII digits, one at a time
    "tab\tand\nnewline ... ---",
    "😀 emoji 🚀!",
]


@pytest.mark.parametrize("text", SPLITS)
def test_split_words_matches_the_regex_pattern(text):
    cleaned = _basic_clean(text)
    assert split_words(cleaned) == _PAT.findall(cleaned)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_clip_bpe_matches_jax(tmp_path, prompt):
    d = str(tiny_clip_files(tmp_path))
    ours, theirs = CLIPBPETokenizer.from_dir(d), JCLIP.from_dir(d)
    assert ours.tokenize(prompt) == theirs.tokenize(prompt)
    for max_length in (77, 16, None):
        assert ours.encode(prompt, max_length=max_length) == theirs.encode(prompt,
                                                                          max_length=max_length)
    ids = ours.encode(prompt)
    assert ours.decode(ids) == theirs.decode(ids)


def test_clip_vocab_is_the_jax_tests_vocab(tmp_path):
    """io/synthetic.py's CLIP files are tests/test_tokenizers.py's."""
    import json

    import test_tokenizers

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    tiny_clip_files(a)
    test_tokenizers._tiny_clip_files(b)
    for name in ("vocab.json", "merges.txt"):
        assert (a / name).read_text(encoding="utf-8") == (b / name).read_text(encoding="utf-8")
    assert synthetic.clip_vocab() == json.loads((b / "vocab.json").read_text(encoding="utf-8"))


def test_model_proto_bytes_match_the_jax_tests_writer():
    import test_tokenizers

    assert serialize_model_proto(TINY_PIECES) == test_tokenizers._serialize_model_proto(
        test_tokenizers.TINY_PIECES)
    assert TINY_PIECES == test_tokenizers.TINY_PIECES


@pytest.mark.parametrize("pieces", ["tiny", "synthetic"])
def test_model_proto_reader_matches_jax(pieces):
    table = TINY_PIECES if pieces == "tiny" else synthetic.spm_pieces()
    data = serialize_model_proto(table)
    assert parse_model_proto(data) == j_parse(data)


@pytest.mark.parametrize("prompt", PROMPTS + ["hello xyz world", "a held word", "ab ba"])
@pytest.mark.parametrize("pieces", ["tiny", "synthetic"])
def test_spm_matches_jax(prompt, pieces):
    table = TINY_PIECES if pieces == "tiny" else synthetic.spm_pieces()
    ours, theirs = SentencePieceUnigram(table), JSPM(table)
    assert ours.tokenize(prompt) == theirs.tokenize(prompt)
    for kw in (dict(max_length=512, add_eos=True, pad_to_max=True),
               dict(max_length=8, add_eos=True, pad_to_max=True),
               dict(max_length=None, add_eos=False)):
        assert ours.encode(prompt, **kw) == theirs.encode(prompt, **kw)
    ids = ours.encode(prompt)
    assert ours.decode(ids) == theirs.decode(ids)


def test_spm_file_loading_and_normalize(tmp_path):
    path = tmp_path / "spiece.model"
    path.write_bytes(serialize_model_proto(TINY_PIECES))
    sp = SentencePieceUnigram.from_file(str(path))
    assert sp.piece_to_id["▁hello"] == 4
    assert sp.unk_id == 2 and sp.eos_id == 1 and sp.pad_id == 0
    assert normalize("Ｈi  there") == "▁Hi▁there"


@pytest.mark.parametrize("prompt", ["a street sign in city, 'hello world'", "مرحبا بالعالم"])
def test_cli_tokenize_matches_jax(tmp_path, prompt):
    """``cli._tokenize`` from a checkpoint directory's tokenizer files gives the
    JAX CLI's ids; without the files it falls back to the CRC32 demo ids."""
    from reptext_tpu.cli import _tokenize as j_tokenize
    from reptext_tpu.configs import CLIPConfig as JCLIPConfig
    from reptext_tpu.configs import T5Config as JT5Config
    from reptext_tpu_torch.cli import _tokenize, demo_token_ids
    from reptext_tpu_torch.configs import CLIPConfig, T5Config

    write_tokenizer_dirs(tmp_path)
    clip, t5 = _tokenize(prompt, CLIPConfig(), T5Config(), str(tmp_path))
    jclip, jt5 = j_tokenize(prompt, JCLIPConfig(), JT5Config(), str(tmp_path))
    assert clip.shape == (1, 77) and t5.shape == (1, 512)
    np.testing.assert_array_equal(clip, np.asarray(jclip))
    np.testing.assert_array_equal(t5, np.asarray(jt5))
    empty = tmp_path / "empty"
    empty.mkdir()
    for fallback in (_tokenize(prompt, CLIPConfig(), T5Config(), str(empty)),
                     _tokenize(prompt, CLIPConfig(), T5Config(), None)):
        for got, want in zip(fallback, demo_token_ids(prompt, CLIPConfig(), T5Config(), 512)):
            np.testing.assert_array_equal(got, want)


def test_pad_to_common_length_is_exported():
    a, b = pad_to_common_length(np.ones((1, 3), np.int64), np.ones((1, 5), np.int64))
    assert a.shape == b.shape == (1, 5) and a[0, 3:].tolist() == [0, 0]
