"""Tokenizer access (get_tokenizer, vlnbert_init.py:4-11).

bert-base-uncased for R2R-family tasks, xlm-roberta-base for RxR.  Works
offline when the HuggingFace cache is pre-populated; in fully air-gapped
environments (such as CI) a deterministic hash-vocab fallback keeps the
pipeline runnable — real training should use the genuine vocab so released
checkpoints' embeddings line up.  The port's own copy of the JAX package's
module: nothing is downloaded.
"""

from __future__ import annotations

import hashlib
import re
import unicodedata


def get_tokenizer(dataset: str = "r2r", tokenizer: str | None = None,
                  vocab_file: str | None = None):
    """vocab_file: path to a real BERT WordPiece vocab.txt — the genuine
    bert-base-uncased vocabulary without needing HF weights on disk."""
    if vocab_file is not None:
        return BertWordPieceTokenizer(vocab_file)
    name = ("xlm-roberta-base" if dataset == "rxr" or tokenizer == "xlm"
            else "bert-base-uncased")
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception:
        return HashTokenizer(name)


class BertWordPieceTokenizer:
    """Real BERT WordPiece over a local vocab.txt (one token per line, line
    number = id): lowercase + punctuation-splitting basic tokenizer, then
    greedy longest-match-first subwords with '##' continuations — the
    algorithm behind bert-base-uncased, so ids line up with released
    checkpoints when given the genuine vocab file."""

    MAX_WORD_CHARS = 100

    def __init__(self, vocab_file: str):
        self.name_or_path = vocab_file
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.vocab_size = len(self.vocab)
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        self.cls_token_id = self.vocab.get("[CLS]", 101)
        self.sep_token_id = self.vocab.get("[SEP]", 102)
        self.mask_token_id = self.vocab.get("[MASK]", 103)
        self.unk_token_id = self.vocab.get("[UNK]", 100)

    @staticmethod
    def _is_punct(ch: str) -> bool:
        # BertTokenizer treats all ASCII non-alnum printables as punctuation
        # (so "don't" splits to don / ' / t) plus every Unicode P* category
        cp = ord(ch)
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        # BasicTokenizer._is_chinese_char ranges: every CJK ideograph is
        # emitted as its own token
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _basic(self, text: str) -> list[str]:
        # BasicTokenizer(do_lower_case=True): clean (drop \x00/� and
        # every category-C char; whitespace is ' \t\n\r' + Zs ONLY —
        # et al. are regular chars there), isolate CJK ideographs,
        # lowercase, NFD accent stripping, split every punctuation char
        text = unicodedata.normalize("NFD", text.lower())
        out: list[str] = []
        word: list[str] = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            cat = unicodedata.category(ch)
            if cat == "Mn":  # strip accents (lowercase implies it in BERT)
                continue
            if ch in " \t\n\r" or cat == "Zs":
                flush()
                continue
            if ch in ("\x00", "�") or cat.startswith("C"):
                continue  # control/format/surrogate/private-use: deleted
            if ch.isspace():
                # Zl/Zp separators survive HF's clean step but its
                # whitespace_tokenize uses str.split(), which splits on them
                flush()
                continue
            if self._is_cjk(ord(ch)):
                flush()
                out.append(ch)
                continue
            if self._is_punct(ch):
                flush()
                out.append(ch)
                continue
            word.append(ch)
        flush()
        return out

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in self._basic(text):
            if len(word) > self.MAX_WORD_CHARS:
                out.append("[UNK]")
                continue
            start, pieces = 0, []
            while start < len(word):
                end, cur = len(word), None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    pieces = ["[UNK]"]
                    break
                pieces.append(cur)
                start = end
            out.extend(pieces)
        return out

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        ids = [self.cls_token_id] \
            + self.convert_tokens_to_ids(self.tokenize(text)) \
            + [self.sep_token_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_token_id]
        return ids

    def __call__(self, text: str, max_length: int | None = None, **kw):
        return {"input_ids": self.encode(text, max_length)}


class HashTokenizer:
    """Deterministic offline stand-in with a BERT-compatible id layout:
    0=[PAD], 1=[CLS], 2=[SEP], 3=[MASK]; words hash into the remaining vocab.
    Suitable for synthetic pipelines and tests only."""

    PAD, CLS, SEP, MASK = 0, 1, 2, 3

    def __init__(self, name: str, vocab_size: int = 30522):
        self.name_or_path = name
        self.vocab_size = vocab_size
        self.pad_token_id = self.PAD
        self.cls_token_id = self.CLS
        self.sep_token_id = self.SEP
        self.mask_token_id = self.MASK

    def tokenize(self, text: str) -> list[str]:
        return re.findall(r"[a-z0-9']+|[^\sa-z0-9]", text.lower())

    def _word_id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
        return 4 + h % (self.vocab_size - 4)

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self._word_id(t) for t in tokens]

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        ids = [self.CLS] + self.convert_tokens_to_ids(self.tokenize(text)) \
            + [self.SEP]
        if max_length is not None:
            ids = ids[: max_length - 1] + [self.SEP] if len(ids) > max_length \
                else ids
        return ids

    def __call__(self, text: str, max_length: int | None = None, **kw):
        return {"input_ids": self.encode(text, max_length)}
