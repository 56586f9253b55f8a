"""YAML training configs, as ``audio_flamingo_tpu/train/config.py``: a dataset mixture,
the stage and the run settings from one file.

```yaml
stage: 1_pretrain            # or mf_1_full_ft ...
batch_size: 8
num_steps: 10000
ckpt_dir: /ckpts/af3-stage1
model:
  preset: tiny               # tiny | af3_7b
mixture:
  - jsonl: /data/audioskills.jsonl
    audio_root: /data/audio
    weight: 3.0
  - tar_shards: ["/data/shard-{000..009}.tar"]
    weight: 1.0
```

The port reads YAML without a YAML package (``read_yaml``): the subset such a file uses,
with the values PyYAML's ``safe_load`` gives it (YAML 1.1 scalars):

- block mappings and block sequences, nested by indentation (spaces), a sequence also at
  its parent key's indentation, a sequence item that opens a mapping (``- key: value``);
- flow sequences of scalars on one line (``["a", 'b', c]``);
- double- and single-quoted scalars, and plain scalars: int (decimal, 0x, 0o-style
  leading 0, 0b, with ``_``), float (a dot, optional signed exponent, .inf, .nan), bool
  (true/false/yes/no/on/off in their three cases), null (~, null, empty) or a string;
- comments (``#`` at a line's start or after a space, outside quotes).

Anything else (flow mappings, anchors and aliases, tags, block scalars ``|`` / ``>``,
document markers, tabs, times and dates) raises a ``ValueError`` that names the line.
"""

from __future__ import annotations

import glob as globlib
import math
import re

from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.train.data import MixtureSampler, Source
from audio_flamingo_tpu_torch.train.loop import TrainRunConfig

# PyYAML's implicit resolvers (YAML 1.1) for the scalars of the subset
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL)?$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
# resolved by PyYAML to something outside the subset: sexagesimal numbers, timestamps
_OUTSIDE = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _fail(line_no: int, what: str):
    raise ValueError(f"YAML line {line_no}: {what} is outside the subset this reader takes")


def _strip_comment(text: str, line_no: int) -> str:
    """The text before an unquoted comment, right-stripped."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if quote == "'" and c == "'" and text[i + 1:i + 2] == "'":
                i += 1
            elif quote == '"' and c == "\\":
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " -[,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _lines(source: str) -> list[_Line]:
    out = []
    for number, raw in enumerate(source.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(number, "a tab in the indentation")
        text = _strip_comment(body, number)
        if not text:
            continue
        if text.startswith(("---", "...", "%")):
            _fail(number, "a document marker or directive")
        out.append(_Line(number, len(raw) - len(body), text))
    return out


def _double_quoted(s: str, line_no: int) -> tuple[str, int]:
    """A double-quoted scalar at the start of s -> (value, characters consumed)."""
    out, i = [], 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _HEX:
                n = _HEX[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                _fail(line_no, f"the escape \\{e}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    _fail(line_no, "a quoted scalar that spans lines")


def _single_quoted(s: str, line_no: int) -> tuple[str, int]:
    out, i = [], 1
    while i < len(s):
        if s[i] == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    _fail(line_no, "a quoted scalar that spans lines")


def _quoted(s: str, line_no: int) -> tuple[str, int]:
    return (_double_quoted if s[0] == '"' else _single_quoted)(s, line_no)


def _plain(s: str, line_no: int):
    """A plain scalar, resolved as PyYAML resolves it."""
    if s[0] in "&*!|>{}@`%" or s.startswith(("? ", "- ")):
        _fail(line_no, f"the plain scalar {s!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        body = v.lstrip("+-")
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        return sign * float(body)
    if _OUTSIDE.match(s):
        _fail(line_no, f"the time or date {s!r}")
    return s


def _scalar(s: str, line_no: int):
    """A whole inline value: a quoted or plain scalar, or a flow sequence of scalars."""
    if s[0] in "'\"":
        value, n = _quoted(s, line_no)
        if s[n:].strip():
            _fail(line_no, f"text after a quoted scalar ({s[n:]!r})")
        return value
    if s[0] == "[":
        return _flow_sequence(s, line_no)
    return _plain(s, line_no)


def _flow_sequence(s: str, line_no: int) -> list:
    if not s.endswith("]"):
        _fail(line_no, "a flow sequence that spans lines")
    body, items, i = s[1:-1], [], 0
    while True:
        while i < len(body) and body[i] == " ":
            i += 1
        if i >= len(body):
            return items
        if body[i] in "'\"":
            value, n = _quoted(body[i:], line_no)
            i += n
        elif body[i] in "[{":
            _fail(line_no, "a nested flow collection")
        else:
            j = body.find(",", i)
            j = len(body) if j < 0 else j
            value = _plain(body[i:j].strip(), line_no)
            i = j
        items.append(value)
        while i < len(body) and body[i] == " ":
            i += 1
        if i < len(body):
            if body[i] != ",":
                _fail(line_no, f"{body[i:]!r} in a flow sequence")
            i += 1


def _split_key(text: str, line_no: int):
    """'key: rest' -> (key, rest) or None when the text is not a mapping entry."""
    if text[0] in "'\"":
        key, n = _quoted(text, line_no)
        rest = text[n:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text.startswith(("[", "{")):
        return None
    for m in re.finditer(r":(?: |$)", text):
        return _plain(text[:m.start()].rstrip(), line_no), text[m.end():].strip()
    return None


def _is_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith("- ")


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines, self.i = lines, 0

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int):
        line = self.peek()
        if _is_item(line):
            return self.sequence(line.indent)
        if _split_key(line.text, line.number) is None:
            _fail(line.number, f"the bare scalar {line.text!r} in a block")
        return self.mapping(line.indent)

    def nested(self, parent_indent: int, allow_same_indent_sequence: bool):
        """The value of an entry whose inline part is empty: the block below it, or
        None."""
        line = self.peek()
        if line is None:
            return None
        if line.indent > parent_indent:
            return self.block(line.indent)
        if allow_same_indent_sequence and line.indent == parent_indent and _is_item(line):
            return self.sequence(line.indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.peek()) is not None and line.indent == indent and not _is_item(line):
            kv = _split_key(line.text, line.number)
            if kv is None:
                _fail(line.number, f"{line.text!r} where a mapping entry was expected")
            key, rest = kv
            self.i += 1
            out[key] = (self.nested(indent, True) if not rest else
                        self.inline(rest, line.number))
        line = self.peek()
        if line is not None and line.indent > indent:
            _fail(line.number, "an indentation that matches no block above it")
        return out

    def inline(self, rest: str, line_no: int):
        if rest[0] in "|>":
            _fail(line_no, "a block scalar")
        if rest[0] in "&*!{":
            _fail(line_no, f"the value {rest!r}")
        return _scalar(rest, line_no)

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line.indent == indent and _is_item(line):
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent, False))
                continue
            col = indent + len(line.text) - len(rest)
            if _is_item(_Line(line.number, col, rest)):
                _fail(line.number, "a sequence nested on one line")
            if _split_key(rest, line.number) is not None:
                # '- key: value' opens a mapping whose entries sit at the key's column
                self.lines[self.i] = _Line(line.number, col, rest)
                out.append(self.mapping(col))
            else:
                self.i += 1
                out.append(self.inline(rest, line.number))
        return out


def read_yaml(text: str):
    """The subset of YAML in the module docstring -> Python values (PyYAML's
    ``safe_load`` of the same text); an empty document is None."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    if lines[0].indent:
        _fail(lines[0].number, "an indented first line")
    if len(lines) == 1 and not _is_item(lines[0]) and _split_key(lines[0].text,
                                                                  lines[0].number) is None:
        return parser.inline(lines[0].text, lines[0].number)
    value = parser.block(0)
    if parser.peek() is not None:
        _fail(parser.peek().number, "a line after the document's top-level block")
    return value


def _expand_braces(pattern: str) -> list[str]:
    """shard-{000..009}.tar brace ranges (the webdataset convention); a pattern without
    one is globbed (itself when nothing matches)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return sorted(globlib.glob(pattern)) or [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
            for i in range(int(lo), int(hi) + 1)]


def load_train_config(path: str):
    """-> (AF3Config, TrainRunConfig, MixtureSampler factory ``make_sampler(seed=0)``)."""
    with open(path) as f:
        raw = read_yaml(f.read())

    preset = (raw.get("model") or {}).get("preset", "tiny")
    if preset == "tiny":
        model_cfg = AF3Config.tiny()
    elif preset == "af3_7b":
        model_cfg = AF3Config()
    else:
        raise ValueError(f"unknown model preset {preset!r}")

    run_cfg = TrainRunConfig(
        stage=raw.get("stage", "1_pretrain"),
        batch_size=int(raw.get("batch_size", 2)),
        num_steps=int(raw.get("num_steps", 100)),
        log_every=int(raw.get("log_every", 10)),
        ckpt_every=int(raw.get("ckpt_every", 500)),
        ckpt_dir=raw.get("ckpt_dir"),
    )

    def make_sampler(seed: int = 0) -> MixtureSampler:
        from audio_flamingo_tpu_torch.train.sources import JsonlSource, TarShardSource

        sources: list[Source] = []
        for entry in raw.get("mixture", []):
            weight = float(entry.get("weight", 1.0))
            if "jsonl" in entry:
                sources.append(JsonlSource(entry["jsonl"],
                                           audio_root=entry.get("audio_root", ""),
                                           weight=weight,
                                           name=entry.get("name")).source())
            elif "tar_shards" in entry:
                shards = []
                for pat in entry["tar_shards"]:
                    shards.extend(_expand_braces(pat))
                sources.append(TarShardSource(shards, weight=weight,
                                              name=entry.get("name", "tar")).source())
            else:
                raise ValueError(f"mixture entry needs 'jsonl' or 'tar_shards': {entry}")
        if not sources:
            raise ValueError("empty mixture")
        return MixtureSampler(sources, seed=seed)

    return model_cfg, run_cfg, make_sampler
