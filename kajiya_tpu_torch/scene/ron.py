"""Tiny RON (Rusty Object Notation) reader for kajiya scene files (a copy
of `kajiya_tpu/scene/ron.py`).

Parses the subset used by `assets/scenes/*.ron` in the reference
(`crates/bin/view/src/scene.rs:1-19`): nested tuples `( field: value, ... )`,
lists `[ ... ]`, numbers, strings. Returns plain Python dict/list/tuple.
"""
from __future__ import annotations

import re

_TOKEN = re.compile(r'''
    (?P<ws>[\s,]+)
  | (?P<comment>//[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+\.?\d*(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[()\[\]:{}])
''', re.VERBOSE)


def _tokenize(text):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"RON parse error at {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()


class _Parser:
    def __init__(self, text):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def parse_value(self):
        kind, val = self.peek()
        if kind == "punct" and val == "(":
            return self.parse_struct()
        if kind == "punct" and val == "[":
            return self.parse_list()
        if kind == "string":
            self.next()
            return val[1:-1]
        if kind == "number":
            self.next()
            return float(val) if ("." in val or "e" in val or "E" in val) else int(val)
        if kind == "ident":
            self.next()
            if val == "true":
                return True
            if val == "false":
                return False
            # enum variant, possibly with a tuple payload
            k, v = self.peek()
            if k == "punct" and v == "(":
                return {val: self.parse_struct()}
            return val
        raise ValueError(f"unexpected token {kind} {val!r}")

    def parse_struct(self):
        self.next()  # (
        # Could be a named-field struct or a positional tuple
        fields, seq = {}, []
        while True:
            kind, val = self.peek()
            if kind == "punct" and val == ")":
                self.next()
                break
            if kind == "ident":
                k2, v2 = self.toks[self.i + 1] if self.i + 1 < len(self.toks) else (None, None)
                if k2 == "punct" and v2 == ":":
                    self.next(); self.next()
                    fields[val] = self.parse_value()
                    continue
            seq.append(self.parse_value())
        if fields and not seq:
            return fields
        if seq and not fields:
            return tuple(seq)
        return fields if fields else tuple(seq)

    def parse_list(self):
        self.next()  # [
        out = []
        while True:
            kind, val = self.peek()
            if kind == "punct" and val == "]":
                self.next()
                return out
            out.append(self.parse_value())


def loads(text: str):
    return _Parser(text).parse_value()


def load(path: str):
    with open(path) as f:
        return loads(f.read())
