"""Tokenizer of the GPT-2 workload: the port's copy of
``commefficient_tpu/data_utils/tokenization.py`` without its
``transformers`` branch.

``BPETokenizer`` is the port's own byte-level BPE (GPT-2's scheme): text
is split on the added tokens, each remaining piece into GPT-2's
pre-tokens, each pre-token's UTF-8 bytes mapped through GPT-2's
bytes-to-unicode table and merged by the ranked merges. It reads a
``vocab.json`` / ``merges.txt`` pair: the port's copy of the vendored
vocabulary (``assets/gpt2_bpe``: the 256 byte symbols and no merges, so
each UTF-8 byte is one token), or a directory that ``save_pretrained``
wrote. Its ids and added-token ids are those HF's ``GPT2Tokenizer``
assigns from the same files: ``<|endoftext|>`` (the unknown token) takes
the first id past the vocabulary, and ``add_special_tokens`` gives the new
tokens the next ids in the order of the mapping (``<bos>``, ``<eos>``,
``<pad>``, ``<speaker1>``, ``<speaker2>``: 257-261 over the vendored
vocabulary). ``save_pretrained`` writes the files HF's tokenizer reads
back to the same ids.

``ByteTokenizer`` (ids 0..255 plus the special tokens) stays the last
fallback, with the JAX package's resolution order in ``get_tokenizer``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import regex

SPECIAL_TOKENS = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>"]
ATTR_TO_SPECIAL_TOKEN = {
    "bos_token": "<bos>",
    "eos_token": "<eos>",
    "pad_token": "<pad>",
    "additional_special_tokens": ("<speaker1>", "<speaker2>"),
}
ENDOFTEXT = "<|endoftext|>"

VENDORED_BPE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "assets", "gpt2_bpe")

# GPT-2's pre-tokenizer: contractions, letter runs, number runs, other
# symbol runs (each with one leading space), and whitespace; ``regex``
# for the Unicode classes, as HF's tokenizer uses it
_PRETOKEN = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
                          r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table: the printable
    Latin-1 bytes map to themselves, the other 68 to code points from 256
    up, in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class BPETokenizer:
    """Byte-level BPE over a ``vocab.json`` / ``merges.txt`` pair, with
    the slice of HF's ``GPT2Tokenizer`` surface the workload calls."""

    def __init__(self, vocab_file: str, merges_file: str,
                 added_tokens: Optional[Dict[str, int]] = None,
                 special: Optional[Dict[str, object]] = None):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.pretokenizer = _PRETOKEN
        self.added: Dict[str, int] = {}
        self.special: Dict[str, object] = {"unk_token": ENDOFTEXT,
                                           "bos_token": ENDOFTEXT,
                                           "eos_token": ENDOFTEXT}
        if added_tokens is not None:
            self.added = dict(sorted(added_tokens.items(),
                                     key=lambda kv: kv[1]))
        elif ENDOFTEXT not in self.encoder:
            self.added[ENDOFTEXT] = len(self.encoder)
        if special is not None:
            self.special.update(special)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str):
        """From a directory holding ``vocab.json`` and ``merges.txt`` (and,
        when ``save_pretrained`` wrote it, ``added_tokens.json`` and
        ``special_tokens_map.json``)."""
        def read(name):
            fn = os.path.join(path, name)
            if not os.path.exists(fn):
                return None
            with open(fn, encoding="utf-8") as f:
                return json.load(f)

        special = read("special_tokens_map.json")
        if special is not None:
            special = {k: _content(v) for k, v in special.items()}
        return cls(os.path.join(path, "vocab.json"),
                   os.path.join(path, "merges.txt"),
                   added_tokens=read("added_tokens.json"), special=special)

    def __len__(self):
        return len(self.encoder) + sum(1 for t in self.added
                                       if t not in self.encoder)

    # -- special tokens ----------------------------------------------------

    def add_special_tokens(self, attr_to_token) -> int:
        """Register each token of the mapping (in its order) that the
        vocabulary and the added tokens lack, at the next id, and record
        the attributes. Returns the number of tokens added."""
        added = 0
        for attr, val in attr_to_token.items():
            toks = list(val) if isinstance(val, (tuple, list)) else [val]
            for t in toks:
                if t not in self.encoder and t not in self.added:
                    self.added[t] = len(self)
                    added += 1
            self.special[attr] = (list(toks)
                                  if attr == "additional_special_tokens"
                                  else toks[0])
        return added

    # -- encoding ----------------------------------------------------------

    def _bpe(self, word: str) -> List[str]:
        """Merge the symbols of one byte-mapped pre-token by rank."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = list(zip(parts[:-1], parts[1:]))
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i + 1 < len(parts) and parts[i] == first
                        and parts[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def _split_added(self, text: str) -> List[str]:
        """``text`` cut around every added token (the longest one first
        where two start at one place); the added tokens stay whole."""
        if not self.added:
            return [text]
        toks = sorted(self.added, key=len, reverse=True)
        out, i, start = [], 0, 0
        while i < len(text):
            hit = next((t for t in toks if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append(text[start:i])
            out.append(hit)
            i += len(hit)
            start = i
        if start < len(text):
            out.append(text[start:])
        return out

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for piece in self._split_added(text):
            if piece in self.added:
                tokens.append(piece)
                continue
            for pre in self.pretokenizer.findall(piece):
                mapped = "".join(self.byte_encoder[b]
                                 for b in pre.encode("utf-8"))
                tokens.extend(self._bpe(mapped))
        return tokens

    def _id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        if token in self.encoder:
            return self.encoder[token]
        return self._id(self.special["unk_token"])

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._id(tokens)
        return [self._id(t) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    # -- saving ------------------------------------------------------------

    def save_pretrained(self, path: str) -> None:
        """Write ``vocab.json``, ``merges.txt``, ``added_tokens.json``,
        ``special_tokens_map.json`` and ``tokenizer_config.json`` in the
        layout HF's ``GPT2Tokenizer.from_pretrained`` reads."""
        os.makedirs(path, exist_ok=True)

        def write(name, obj):
            with open(os.path.join(path, name), "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=2, ensure_ascii=False)
                f.write("\n")

        write("vocab.json", self.encoder)
        with open(os.path.join(path, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in sorted(self.bpe_ranks.items(),
                                    key=lambda kv: kv[1]):
                f.write(f"{a} {b}\n")
        write("added_tokens.json", self.added)
        write("special_tokens_map.json", self.special)
        write("tokenizer_config.json", {
            "add_bos_token": False,
            "add_prefix_space": False,
            "added_tokens_decoder": {
                str(i): {"content": t, "lstrip": False,
                         "normalized": t == ENDOFTEXT, "rstrip": False,
                         "single_word": False, "special": True}
                for t, i in self.added.items()},
            "clean_up_tokenization_spaces": False,
            "errors": "replace",
            "tokenizer_class": "GPT2Tokenizer",
            **self.special})


def _content(v):
    """A special-token entry as ``special_tokens_map.json`` may hold it:
    a string, a ``{"content": ...}`` record, or a list of either."""
    if isinstance(v, list):
        return [_content(x) for x in v]
    if isinstance(v, dict):
        return v["content"]
    return v


class ByteTokenizer:
    """Byte-level fallback tokenizer with the same surface: ids 0..255,
    special tokens from 256 (the JAX package's ``ByteTokenizer``)."""

    def __init__(self):
        self.encoder: Dict[str, int] = {chr(i): i for i in range(256)}
        self.special: Dict[str, int] = {}

    def __len__(self):
        return 256 + len(self.special)

    def add_special_tokens(self, attr_to_token) -> int:
        added = 0
        for v in attr_to_token.values():
            toks = v if isinstance(v, (tuple, list)) else [v]
            for t in toks:
                if t not in self.special:
                    self.special[t] = 256 + len(self.special)
                    added += 1
        return added

    def tokenize(self, text: str) -> List[str]:
        return [chr(b) for b in text.encode("utf-8", errors="replace")]

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            tokens = [tokens]
            single = True
        else:
            single = False
        ids = [self.special[t] if t in self.special else
               (ord(t) % 256 if len(t) == 1 else 0) for t in tokens]
        return ids[0] if single else ids

    def encode(self, text: str):
        return self.convert_tokens_to_ids(self.tokenize(text))

    def save_pretrained(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "byte_tokenizer.json"), "w") as f:
            json.dump({"special": self.special}, f)

    @classmethod
    def from_pretrained(cls, path: str):
        tok = cls()
        fn = os.path.join(path, "byte_tokenizer.json")
        if os.path.exists(fn):
            with open(fn) as f:
                tok.special = json.load(f)["special"]
        return tok


def _has_bpe_files(path: str) -> bool:
    return all(os.path.exists(os.path.join(path, f))
               for f in ("vocab.json", "merges.txt"))


def get_tokenizer(model_checkpoint: str = "gpt2"):
    """The JAX package's resolution order, with the port's BPE where it
    takes HF's: a directory of BPE files (``model_checkpoint``); a
    directory a ``ByteTokenizer`` run saved; the vendored byte-level BPE;
    ``ByteTokenizer`` as the last resort."""
    is_dir = os.path.isdir(model_checkpoint)
    if is_dir and _has_bpe_files(model_checkpoint):
        return BPETokenizer.from_pretrained(model_checkpoint)
    if is_dir and os.path.exists(
            os.path.join(model_checkpoint, "byte_tokenizer.json")):
        # a run dir saved by a ByteTokenizer round: keep the round trip
        return ByteTokenizer.from_pretrained(model_checkpoint)
    if _has_bpe_files(VENDORED_BPE_DIR):
        return BPETokenizer.from_pretrained(VENDORED_BPE_DIR)
    if is_dir:
        return ByteTokenizer.from_pretrained(model_checkpoint)
    return ByteTokenizer()


__all__ = ["ATTR_TO_SPECIAL_TOKEN", "SPECIAL_TOKENS", "BPETokenizer",
           "ByteTokenizer", "bytes_to_unicode", "get_tokenizer"]
