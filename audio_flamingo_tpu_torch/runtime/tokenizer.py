"""Byte-level BPE tokenizer (Qwen2/GPT-2 family): Python pretokenization, the merge loop
in C++ (``runtime/cpp/bpe.cpp``) or in Python.

Same algorithm and vocab formats as ``audio_flamingo_tpu/runtime/tokenizer.py``. The
native merge loop is built by g++ into the port's ``_build/`` at first use and bound with
ctypes (``use_native=True``, the default, as in JAX). As in JAX, a pretoken the native
encoder cannot answer (more than ``NATIVE_MAX_IDS`` ids) goes through the Python merge
loop, and so does every pretoken of a vocab the library cannot hold (ids not dense
0..N-1, or an empty or multi-line entry). Unlike JAX, a failed build raises with g++'s
stderr instead of falling back. The Qwen2 pretokenizer
regex uses Unicode property classes (``\\p{L}``, ``\\p{N}``) that the standard ``re``
module lacks, so the classes are spelled out as code-point ranges from ``unicodedata``
once per process, and ``\\s`` is the Unicode White_Space set. No third-party regex
package is needed.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import re
import sys
import threading
import unicodedata
from typing import Iterable

from audio_flamingo_tpu_torch.ops.kernels import _build

# AF-specific special tokens (audio placeholder; Qwen2 chat markers)
DEFAULT_SPECIAL_TOKENS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<sound>",
                          "<|audio_bos|>", "<|audio_eos|>")

# Unicode White_Space (what \s means to the regex engines HF tokenizers use; the
# stdlib's \s also takes U+001C..U+001F)
_WHITESPACE = "\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029\\u202f\\u205f\\u3000"


def _category_ranges(prefix: str) -> str:
    """Regex class body of every code point whose general category starts with prefix."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and unicodedata.category(chr(cp)).startswith(prefix)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            out.append(f"\\U{start:08x}" if start == prev else f"\\U{start:08x}-\\U{prev:08x}")
            start = None
        prev = cp
    return "".join(out)


@functools.lru_cache(maxsize=1)
def pretokenize_pattern() -> re.Pattern:
    """Qwen2's pretokenizer ([hf] tokenization_qwen2.py:39) in stdlib ``re`` syntax:
    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|
     ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+"""
    L, N, S = _category_ranges("L"), _category_ranges("N"), _WHITESPACE
    return re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{L}{N}]?[{L}]+|[{N}]|"
        rf" ?[^{S}{L}{N}]+[\r\n]*|[{S}]*[\r\n]+|[{S}]+(?![^{S}])|[{S}]+")


@functools.lru_cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 reversible byte<->unicode table ([hf] tokenization_qwen2.py:44-67)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


CPP_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp", "bpe.cpp")
NATIVE_MAX_IDS = 4096   # ids one native call may return (JAX's buffer); longer: Python

_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    """ctypes handle to the native BPE library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        path, _, _ = _build.compile_library("g++", ("-O3", "-shared", "-fPIC"), [CPP_SOURCE],
                                            "libaf_bpe")
        lib = ctypes.CDLL(path)
        lib.af_bpe_new.restype = ctypes.c_void_p
        lib.af_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
                                   ctypes.c_uint64]
        lib.af_bpe_encode.restype = ctypes.c_int64
        lib.af_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64]
        lib.af_bpe_free.restype = None
        lib.af_bpe_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeBpe:
    """One vocab and merge table in the native library (JAX ``_NativeBpe``). ``encode``
    is serialized by a lock: the library's per-table cache is not thread-safe."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        lib = get_lib()
        inv = sorted(vocab.items(), key=lambda kv: kv[1])
        vocab_blob = "\n".join(k for k, _ in inv).encode("utf-8")
        merges_blob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        handle = lib.af_bpe_new(vocab_blob, len(vocab_blob), merges_blob, len(merges_blob))
        if not handle:
            raise RuntimeError("af_bpe_new returned no table")
        self._lib, self._handle = lib, handle
        self._buf = (ctypes.c_int32 * NATIVE_MAX_IDS)()
        self._lock = threading.Lock()

    @staticmethod
    def supports(vocab: dict[str, int], merges: list[tuple[str, str]]) -> bool:
        """The library's line-indexed format holds this table: ids dense 0..N-1 (JAX's
        test), every entry one non-empty line and every merge two words."""
        if sorted(vocab.values()) != list(range(len(vocab))):
            return False
        if any(not k or "\n" in k for k in vocab):
            return False
        return all(a and b and not any(c in a + b for c in " \n") for a, b in merges)

    def encode(self, pretoken: str) -> list[int] | None:
        """The pretoken's ids, or None where the library answers -1 (an unknown piece, or
        more than NATIVE_MAX_IDS ids)."""
        data = pretoken.encode("utf-8")
        with self._lock:
            n = self._lib.af_bpe_encode(self._handle, data, len(data), self._buf,
                                        NATIVE_MAX_IDS)
            return None if n < 0 else list(self._buf[:n])

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.af_bpe_free(handle)


class BBPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: Iterable[str] = DEFAULT_SPECIAL_TOKENS,
                 use_native: bool = True):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.merges = [tuple(m) for m in merges]
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = pretokenize_pattern()
        self.special_tokens: dict[str, int] = {}
        for tok in special_tokens:
            if tok in self.vocab:
                self.special_tokens[tok] = self.vocab[tok]
        self._special_pat = None
        if self.special_tokens:
            self._special_pat = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(self.special_tokens,
                                                            key=len, reverse=True)) + ")")
        self._bpe_cache: dict[str, list[str]] = {}
        self.use_native = use_native
        self._native = self._native_table()

    def _native_table(self) -> NativeBpe | None:
        if self.use_native and NativeBpe.supports(self.vocab, self.merges):
            return NativeBpe(self.vocab, self.merges)
        return None

    def __getstate__(self) -> dict:
        # the native table is a pointer into this process: a copy builds its own
        return {k: v for k, v in self.__dict__.items() if k != "_native"}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._native = self._native_table()

    # ---------------------------------------------------------------- construction
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "BBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw) -> "BBPETokenizer":
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        vocab = dict(model["vocab"])
        merges = [tuple(m.split(" ") if isinstance(m, str) else m) for m in model["merges"]]
        added = [t["content"] for t in tj.get("added_tokens", [])]
        for t in tj.get("added_tokens", []):
            vocab.setdefault(t["content"], t["id"])
        specials = list(dict.fromkeys(list(kw.pop("special_tokens", ())) + added
                                      + list(DEFAULT_SPECIAL_TOKENS)))
        return cls(vocab, merges, special_tokens=specials, **kw)

    @classmethod
    def from_pretrained_dir(cls, path: str, **kw) -> "BBPETokenizer":
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            return cls.from_tokenizer_json(tj, **kw)
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"), **kw)

    # ---------------------------------------------------------------------- encode
    def _bpe(self, token: str) -> list[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._bpe_cache[token] = word
        return word

    def _encode_ordinary(self, text: str) -> list[int]:
        ids = []
        native = self._native
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            if native is not None:
                got = native.encode(mapped)
                if got is not None:
                    ids.extend(got)
                    continue
            for piece in self._bpe(mapped):
                ids.append(self.vocab[piece])
        return ids

    def encode(self, text: str, allow_special: bool = True) -> list[int]:
        # Qwen2 normalizes to NFC before tokenizing; decode inverts up to NFC
        text = unicodedata.normalize("NFC", text)
        if not allow_special or self._special_pat is None:
            return self._encode_ordinary(text)
        ids: list[int] = []
        for part in self._special_pat.split(text):
            if not part:
                continue
            if part in self.special_tokens:
                ids.append(self.special_tokens[part])
            else:
                ids.extend(self._encode_ordinary(part))
        return ids

    # ---------------------------------------------------------------------- decode
    def decode(self, ids: Iterable[int], skip_special: bool = False) -> str:
        special_ids = set(self.special_tokens.values())
        out = []
        buf = []  # byte-level pieces
        for i in ids:
            i = int(i)
            tok = self.inv_vocab.get(i)
            if tok is None:
                continue
            if i in special_ids:
                if buf:
                    out.append(self._decode_pieces(buf))
                    buf = []
                if not skip_special:
                    out.append(tok)
            else:
                buf.append(tok)
        if buf:
            out.append(self._decode_pieces(buf))
        return "".join(out)

    def _decode_pieces(self, pieces: list[str]) -> str:
        data = bytes(self.byte_decoder[c] for c in "".join(pieces))
        return data.decode("utf-8", errors="replace")


def train_bpe(texts: Iterable[str], vocab_size: int,
              special_tokens: Iterable[str] = DEFAULT_SPECIAL_TOKENS):
    """Tiny BPE trainer (tests/tooling; not a production trainer): returns (vocab, merges)."""
    be = bytes_to_unicode()
    pat = pretokenize_pattern()
    words: dict[tuple[str, ...], int] = {}
    for text in texts:
        for tok in pat.findall(text):
            mapped = tuple(be[b] for b in tok.encode("utf-8"))
            words[mapped] = words.get(mapped, 0) + 1
    vocab_set = sorted(be.values())
    vocab = {s: i for i, s in enumerate(vocab_set)}
    merges: list[tuple[str, str]] = []
    while len(vocab) + len(tuple(special_tokens)) < vocab_size:
        pair_counts: dict[tuple[str, str], int] = {}
        for w, c in words.items():
            for i in range(len(w) - 1):
                pair_counts[(w[i], w[i + 1])] = pair_counts.get((w[i], w[i + 1]), 0) + c
        if not pair_counts:
            break
        best = max(pair_counts, key=lambda p: (pair_counts[p], p))
        merges.append(best)
        vocab["".join(best)] = len(vocab)
        new_words = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + c
        words = new_words
    for t in special_tokens:
        vocab[t] = len(vocab)
    return vocab, merges
