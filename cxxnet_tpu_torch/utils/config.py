"""`key = value` config tokenizer and the schema check's entry (own copy
of cxxnet_tpu/utils/config.py; the key registry is the port's own,
analysis/schema.py).

Behavioral parity with the reference tokenizer (src/utils/config.h:20-186):

- `#` starts a comment that runs to end of line.
- Tokens are whitespace-separated; `=` is its own token even when glued to
  neighbours (``a=b`` tokenizes as ``a``, ``=``, ``b``).
- Double-quoted strings are single-line, support backslash escapes, and must
  terminate before the newline; single-quoted strings may span lines.
- A quote may only open a token at the token's start.
- The stream is consumed as (name, '=', value) triples; anything else is a
  parse error (the reference silently stops - we raise, which is strictly
  more helpful and only differs on already-broken files).
"""

from __future__ import annotations

import io
from typing import Iterator, List, Mapping, Tuple


class ConfigError(ValueError):
    """Raised on malformed config input."""


def is_inert(val: str, inert: Tuple[str, ...]) -> bool:
    """True when `val` is one of the inert values (equal as text or as
    numbers)."""
    for want in inert:
        if val == want:
            return True
        try:
            if float(val) == float(want):
                return True
        except ValueError:
            pass
    return False


def check_ported(table: Mapping[str, Tuple[str, ...]], name: str,
                 val: str) -> None:
    """Raise NotImplementedError naming `name` when it is a key of
    `table` - a key of the JAX package the port does not implement yet,
    mapped to its inert values - set to anything else. The tables are the
    module-level `_NOT_PORTED` dicts the schema registry also reads."""
    if name in table and not is_inert(val, table[name]):
        raise NotImplementedError(
            f"{name} = {val}: not ported to cxxnet_tpu_torch yet (see "
            "ROADMAP)")


_EOF = ""


class _Tokenizer:
    """Character-level tokenizer mirroring ConfigReaderBase::GetNextToken."""

    def __init__(self, stream: io.TextIOBase):
        self._stream = stream
        self._ch = self._stream.read(1)

    def _next_char(self) -> None:
        self._ch = self._stream.read(1)

    def _skip_line(self) -> None:
        while self._ch not in (_EOF, "\n", "\r"):
            self._next_char()

    def _parse_quoted(self, terminator: str, allow_newline: bool) -> str:
        out: List[str] = []
        while True:
            self._next_char()
            ch = self._ch
            if ch == _EOF:
                raise ConfigError("ConfigReader: unterminated string")
            if ch == "\\":
                self._next_char()
                out.append(self._ch)
                continue
            if ch == terminator:
                return "".join(out)
            if ch in ("\r", "\n") and not allow_newline:
                raise ConfigError("ConfigReader: unterminated string")
            out.append(ch)

    def next_token(self) -> str | None:
        """Return the next token, or None at end of stream. Sets
        `last_token_new_line` when a newline (or line comment) was
        crossed before the token - the reference's new_line flag
        (config.h GetNextToken), used to reject key/'='/value split
        across lines."""
        tok: List[str] = []
        self.last_token_new_line = False
        while self._ch != _EOF:
            ch = self._ch
            if ch == "#":
                self._skip_line()
                if not tok:
                    self.last_token_new_line = True
            elif ch in ('"', "'"):
                if tok:
                    raise ConfigError(
                        "ConfigReader: token followed directly by string")
                s = self._parse_quoted(ch, allow_newline=(ch == "'"))
                self._next_char()
                return s
            elif ch == "=":
                if not tok:
                    self._next_char()
                    return "="
                return "".join(tok)
            elif ch in (" ", "\t", "\r", "\n"):
                self._next_char()
                if tok:
                    return "".join(tok)
                if ch in ("\r", "\n"):
                    self.last_token_new_line = True
            else:
                tok.append(ch)
                self._next_char()
        if tok:
            return "".join(tok)
        return None


class ConfigIterator:
    """Iterates (name, value) pairs from a config stream.

    Mirrors utils::ConfigIterator (src/utils/config.h:169-186): pulls
    (token, '=', token) triples until the stream ends.
    """

    def __init__(self, stream: io.TextIOBase):
        self._tok = _Tokenizer(stream)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return self

    def __next__(self) -> Tuple[str, str]:
        name = self._tok.next_token()
        if name is None:
            raise StopIteration
        if name == "=":
            raise ConfigError("ConfigReader: stray '='")
        eq = self._tok.next_token()
        if eq != "=":
            raise ConfigError(
                f"ConfigReader: expected '=' after {name!r}, got {eq!r}")
        if self._tok.last_token_new_line:
            # the reference's reader refuses a key/'='/value pair split
            # across lines (config.h Next's new_line bail) - but it
            # does so by SILENTLY ignoring the rest of the file; we
            # fail loudly instead
            raise ConfigError(
                f"ConfigReader: '=' for {name!r} must be on the same "
                "line as the key")
        val = self._tok.next_token()
        if val is None or val == "=":
            raise ConfigError(f"ConfigReader: missing value for {name!r}")
        if self._tok.last_token_new_line:
            raise ConfigError(
                f"ConfigReader: value for {name!r} must be on the same "
                "line as the key")
        return name, val


def parse_config_string(text: str) -> List[Tuple[str, str]]:
    """Parse a config document into an ordered list of (name, value)."""
    return list(ConfigIterator(io.StringIO(text)))


def parse_config_file(fname: str) -> List[Tuple[str, str]]:
    """Parse a config file into an ordered list of (name, value)."""
    with open(fname, "r", encoding="utf-8") as f:
        return list(ConfigIterator(f))


def validate_known_keys(pairs: List[Tuple[str, str]],
                        source: str = "") -> None:
    """Schema check on parsed pairs: every key must be recognized by
    some component of the port - a set_param handler, a structural key,
    or a key the port lists as not ported yet (that one raises
    NotImplementedError where it is set). An unknown key raises
    ConfigError with a did-you-mean suggestion instead of silently
    configuring nothing. The CLI runs this on every parsed config unless
    `schema_check = 0`."""
    from cxxnet_tpu_torch.analysis import schema
    schema.validate_pairs(pairs, source=source)
