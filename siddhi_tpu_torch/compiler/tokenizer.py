"""SiddhiQL tokenizer.

Token surface follows the reference lexer
(modules/siddhi-query-compiler/.../SiddhiQL.g4 lexer rules, lines ~712-880):
case-insensitive keywords (matched at the parser level — keywords are valid
names per the `name: id|keyword` rule), int/long(l)/float(f)/double literals,
single/double/triple-quoted strings, `backquoted` ids, // and /* */ comments,
annotations, and multi-char operators -> == != <= >= ... .
"""
from __future__ import annotations

import dataclasses
from typing import List


from ..exceptions import SiddhiParserException as _BaseParserException


class SiddhiParserException(_BaseParserException):
    def __init__(self, message: str, line: int = 0, col: int = 0):
        super().__init__(f"{message} (line {line}, col {col})")
        self.message = message
        self.line = line
        self.col = col


@dataclasses.dataclass
class Token:
    kind: str      # ID STRING INT LONG FLOAT DOUBLE PUNCT SCRIPT EOF
    text: str
    value: object
    line: int
    col: int

    @property
    def lower(self) -> str:
        return self.text.lower()

    def __repr__(self):
        return f"Token({self.kind},{self.text!r})"


_PUNCT2 = ("->", "==", "!=", "<=", ">=", "...")
_PUNCT1 = "():;.[],=*+?-/%<>@#!{}"


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    line, col = 1, 1

    def err(msg):
        raise SiddhiParserException(msg, line, col)

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and text[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            advance(1)
            continue
        # comments
        if text.startswith("//", i) or text.startswith("--", i):
            j = text.find("\n", i)
            advance((j - i) if j >= 0 else (n - i))
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                err("unterminated block comment")
            advance(j + 2 - i)
            continue
        ln, cl = line, col
        # strings (''' / """ / ' / ")
        if text.startswith("'''", i) or text.startswith('"""', i):
            q = text[i:i + 3]
            j = text.find(q, i + 3)
            if j < 0:
                err("unterminated string")
            val = text[i + 3:j]
            advance(j + 3 - i)
            toks.append(Token("STRING", val, val, ln, cl))
            continue
        if c in "'\"":
            j = i + 1
            while j < n and text[j] != c:
                if text[j] == "\n":
                    err("unterminated string")
                j += 1
            if j >= n:
                err("unterminated string")
            val = text[i + 1:j]
            advance(j + 1 - i)
            toks.append(Token("STRING", val, val, ln, cl))
            continue
        # script body { ... } (define function): raw capture with balanced
        # braces, skipping over quoted strings inside the script
        if c == "{":
            depth = 0
            j = i
            while j < n:
                ch = text[j]
                if ch in "'\"":
                    q = ch
                    j += 1
                    while j < n and text[j] != q:
                        j += 2 if text[j] == "\\" else 1
                    j += 1
                    continue
                if ch == "{":
                    depth += 1
                elif ch == "}":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if j >= n:
                err("unterminated { script body }")
            val = text[i + 1:j]
            advance(j + 1 - i)
            toks.append(Token("SCRIPT", val, val, ln, cl))
            continue
        # backquoted id
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                err("unterminated quoted identifier")
            val = text[i + 1:j]
            advance(j + 1 - i)
            toks.append(Token("ID", val, val, ln, cl))
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = text[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # '...' (aggregation range) must not be eaten
                    if text.startswith("...", j):
                        break
                    # trailing '.' followed by identifier => attribute access?
                    # SiddhiQL has no "1.x" member access on numbers; the
                    # reference lexer takes digits '.' digits as double.
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                        text[j + 1].isdigit() or
                        (text[j + 1] in "+-" and j + 2 < n and
                         text[j + 2].isdigit())):
                    seen_exp = True
                    j += 1 + (1 if text[j + 1] in "+-" else 0)
                else:
                    break
            num = text[i:j]
            suffix = text[j].lower() if j < n and text[j].lower() in "lfd" else ""
            if suffix:
                j += 1
            if suffix == "l":
                tok = Token("LONG", num, int(num), ln, cl)
            elif suffix == "f":
                tok = Token("FLOAT", num, float(num), ln, cl)
            elif suffix == "d" or seen_dot or seen_exp:
                tok = Token("DOUBLE", num, float(num), ln, cl)
            else:
                tok = Token("INT", num, int(num), ln, cl)
            advance(j - i)
            toks.append(tok)
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            val = text[i:j]
            advance(j - i)
            toks.append(Token("ID", val, val, ln, cl))
            continue
        # punctuation
        matched = None
        for p in _PUNCT2:
            if text.startswith(p, i):
                matched = p
                break
        if matched is None and c in _PUNCT1:
            matched = c
        if matched is None:
            err(f"unexpected character {c!r}")
        advance(len(matched))
        toks.append(Token("PUNCT", matched, matched, ln, cl))

    toks.append(Token("EOF", "", None, line, col))
    return toks
