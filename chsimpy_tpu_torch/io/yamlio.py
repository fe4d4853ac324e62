"""YAML import/export of scalar parameter/solution mappings, without PyYAML.

The files of ``chsimpy_tpu/io/yamlio.py``: an explicit-start document
tagged ``!Parameters`` / ``!Solution`` with one scalar per line, keys
sorted.  :func:`export_scalars` writes what PyYAML's ``SafeDumper``
(``default_flow_style=False, width=1000``) writes for the values a
``scalar_dict`` holds, byte for byte:

* floats as ``repr`` in lower case, with ``.0`` put before an exponent
  that has no decimal point (``1.0e-05``), ``.inf``, ``-.inf``, ``.nan``;
* ints, ``true`` / ``false``, ``null``;
* strings plain where YAML 1.1 reads them back as the same string, else in
  single quotes (``'1.0'``, ``'true'``, ``''``), or in double quotes with
  escapes where they hold a character outside printable ASCII (a string
  with a line break is refused: PyYAML folds it over several lines);
* lists and tuples of those as block sequences (``- x`` lines under the
  key), the empty list as ``[]``.

:func:`import_scalars` reads those files and the reference's
(``chsimpy/utils.py:61-76``): a top-level mapping of plain, quoted or
block-literal scalars and sequences, with the tags ``!Parameters``,
``!Solution``, ``!numpy.float64`` and ``!ndarray`` (parsed with
``ast.literal_eval``, never ``eval``).  Plain scalars resolve as YAML 1.1
does (null, bool, int, float; a timestamp stays a string).  Nested
mappings and anchors are refused: the scalar files never hold them.
"""

from __future__ import annotations

import ast
import math
import re

import numpy as np

# ----------------------------------------------------------------------
# YAML 1.1 implicit resolution (PyYAML's resolver.py)
# ----------------------------------------------------------------------

_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False'
                   r'|FALSE|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*'
                    r'|[-+]?\.(?:inf|Inf|INF)'
                    r'|\.(?:nan|NaN|NAN))$')
_INT = re.compile(r'^(?:[-+]?0b[0-1_]+'
                  r'|[-+]?0[0-7_]+'
                  r'|[-+]?(?:0|[1-9][0-9_]*)'
                  r'|[-+]?0x[0-9a-fA-F_]+'
                  r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$')
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP = re.compile(
    r'^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]'
    r'|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?'
    r'(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?'
    r'(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$')


def _implicit_kind(s: str) -> str:
    """What a plain scalar resolves to: 'null', 'bool', 'int', 'float',
    'timestamp', 'merge', 'value' or 'str' (first characters as PyYAML's
    resolver keys them)."""
    c = s[:1]
    if c in ('', '~', 'n', 'N') and _NULL.match(s):
        return 'null'
    if c and c in 'yYnNtTfFoO' and _BOOL.match(s):
        return 'bool'
    if c and c in '-+0123456789.' and _FLOAT.match(s):
        return 'float'
    if c and c in '-+0123456789' and _INT.match(s):
        return 'int'
    if c and c in '0123456789' and _TIMESTAMP.match(s):
        return 'timestamp'
    if s == '<<':
        return 'merge'
    if s == '=':
        return 'value'
    return 'str'


def _sexagesimal(digits: str, last) -> float:
    total, base = 0, 1
    parts = [last(p) for p in digits.split(':')]
    for p in reversed(parts):
        total += p * base
        base *= 60
    return total


def _construct_int(s: str) -> int:
    v = s.replace('_', '')
    sign = -1 if v[0] == '-' else 1
    if v[0] in '+-':
        v = v[1:]
    if v == '0':
        return 0
    if v.startswith('0b'):
        return sign * int(v[2:], 2)
    if v.startswith('0x'):
        return sign * int(v[2:], 16)
    if v[0] == '0':
        return sign * int(v, 8)
    if ':' in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _construct_float(s: str) -> float:
    v = s.replace('_', '').lower()
    sign = -1.0 if v[0] == '-' else 1.0
    if v[0] in '+-':
        v = v[1:]
    if v == '.inf':
        return sign * math.inf
    if v == '.nan':
        return math.nan
    if ':' in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _resolve_plain(s: str):
    kind = _implicit_kind(s)
    if kind == 'null':
        return None
    if kind == 'bool':
        return s.lower() in ('yes', 'true', 'on')
    if kind == 'int':
        return _construct_int(s)
    if kind == 'float':
        return _construct_float(s)
    return s


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------

_SPACE = '\0 \t\r\n\x85\u2028\u2029'
_BREAKS = '\n\x85\u2028\u2029'
_ESCAPES = {'\0': '0', '\x07': 'a', '\x08': 'b', '\x09': 't', '\x0A': 'n',
            '\x0B': 'v', '\x0C': 'f', '\x0D': 'r', '\x1B': 'e', '"': '"',
            '\\': '\\', '\x85': 'N', '\xA0': '_', '\u2028': 'L',
            '\u2029': 'P'}


def _string_styles(s: str):
    """(block plain allowed, single quotes allowed) for a string, as
    PyYAML's ``Emitter.analyze_scalar`` decides them for a block
    context (``allow_unicode`` off, as ``safe_dump`` leaves it)."""
    if not s:
        return True, True
    indicators = s.startswith('---') or s.startswith('...')
    special = line_breaks = False
    leading = s[0] == ' ' or s[0] in _BREAKS
    trailing = s[-1] == ' ' or s[-1] in _BREAKS
    break_space = space_break = False
    prev_space = prev_break = False
    for i, ch in enumerate(s):
        followed = i + 1 >= len(s) or s[i + 1] in _SPACE
        preceded = i == 0 or s[i - 1] in _SPACE
        if i == 0:
            if ch in '#,[]{}&*!|>\'"%@`':
                indicators = True
            if ch in '?:-' and followed:
                indicators = True
        elif (ch == ':' and followed) or (ch == '#' and preceded):
            indicators = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == '\n' or '\x20' <= ch <= '\x7E'):
            special = True
        if ch == ' ':
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
    plain = not (leading or trailing or break_space or space_break
                 or special or line_breaks or indicators)
    single = not (break_space or space_break or special)
    return plain, single


def _double_quoted(s: str) -> str:
    out = []
    for ch in s:
        if ch in '"\\\x85\u2028\u2029\uFEFF' or not '\x20' <= ch <= '\x7E':
            if ch in _ESCAPES:
                out.append('\\' + _ESCAPES[ch])
            elif ch <= '\xFF':
                out.append('\\x%02X' % ord(ch))
            elif ch <= '\uFFFF':
                out.append('\\u%04X' % ord(ch))
            else:
                out.append('\\U%08X' % ord(ch))
        else:
            out.append(ch)
    return '"' + ''.join(out) + '"'


def _scalar_text(v) -> str:
    if v is None:
        return 'null'
    if isinstance(v, (bool, np.bool_)):
        return 'true' if v else 'false'
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if v != v:
            return '.nan'
        if v == math.inf:
            return '.inf'
        if v == -math.inf:
            return '-.inf'
        text = repr(v).lower()
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e', 1)
        return text
    if isinstance(v, str):
        if any(ch in _BREAKS or ch == '\r' for ch in v):
            # PyYAML folds such a string over several lines
            raise ValueError(f"no one-line YAML form for {v!r}")
        plain, single = _string_styles(v)
        if plain and _implicit_kind(v) == 'str':
            return v
        if single:
            return "'" + v.replace("'", "''") + "'"
        return _double_quoted(v)
    raise TypeError(f"no YAML scalar form for {type(v).__name__}")


def dumps_scalars(mapping: dict, tag: str) -> str:
    """The text of :func:`export_scalars`."""
    lines = [f"--- !{tag}"]
    if not mapping:
        lines.append('{}')
    for k in sorted(mapping):
        v = mapping[k]
        key = _scalar_text(k)
        if isinstance(v, np.ndarray) and v.ndim == 1:
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            if not v:
                lines.append(f"{key}: []")
                continue
            lines.append(f"{key}:")
            lines.extend(f"- {_scalar_text(x)}" for x in v)
        else:
            lines.append(f"{key}: {_scalar_text(v)}")
    return '\n'.join(lines) + '\n'


def export_scalars(fname: str, mapping: dict, tag: str) -> None:
    with open(fname, 'w') as f:
        f.write(dumps_scalars(mapping, tag))


# ----------------------------------------------------------------------
# import
# ----------------------------------------------------------------------

_KEY = re.compile(r"^(?P<key>'(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"|[^\s#'\"]"
                  r"[^:]*?|[^\s#'\"]*?)\s*:(?:[ \t]+(?P<rest>.*))?$")
_UNESCAPES = {v: k for k, v in _ESCAPES.items()}
_UNESCAPES['/'] = '/'


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(' '))


def _strip_comment(s: str) -> str:
    m = re.search(r'(^|[ \t])#', s)
    return (s[:m.start()] if m else s).rstrip()


def _quoted_end(s: str) -> int:
    """The index one past the closing quote of the quoted scalar that
    starts ``s``."""
    q, i = s[0], 1
    while i < len(s):
        if s[i] == '\\' and q == '"':
            i += 2
            continue
        if s[i] == q:
            if q == "'" and s[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    raise ValueError(f"unterminated quoted scalar {s!r}")


def _unquote(s: str):
    """The string of a single- or double-quoted scalar (one line)."""
    if s[0] == "'":
        if len(s) < 2 or s[-1] != "'":
            raise ValueError(f"unterminated quoted scalar {s!r}")
        return s[1:-1].replace("''", "'")
    if len(s) < 2 or s[-1] != '"':
        raise ValueError(f"unterminated quoted scalar {s!r}")
    body, out, i = s[1:-1], [], 0
    while i < len(body):
        ch = body[i]
        if ch != '\\':
            out.append(ch)
            i += 1
            continue
        e = body[i + 1]
        if e in _UNESCAPES:
            out.append(_UNESCAPES[e])
            i += 2
        elif e in 'xuU':
            n = {'x': 2, 'u': 4, 'U': 8}[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unknown escape \\{e} in {s!r}")
    return ''.join(out)


def _tagged(tag, text: str, quoted: bool):
    """The value of a scalar with its tag (None: untagged)."""
    if tag is None:
        return text if quoted else _resolve_plain(text)
    if tag == '!numpy.float64' or tag == '!!float':
        return _construct_float(text) if not quoted else float(text)
    if tag == '!ndarray':
        return np.array(ast.literal_eval(text.replace('\n', '')))
    if tag == '!!int':
        return _construct_int(text)
    if tag == '!!str':
        return text
    if tag == '!!bool':
        return text.lower() in ('yes', 'true', 'on')
    if tag == '!!null':
        return None
    raise ValueError(f"unknown YAML tag {tag}")


def _block_scalar(header: str, lines, i: int, parent: int):
    """A literal or folded block scalar starting on line i; returns
    (text, next line index)."""
    style, chomp = header[0], header[1:2]
    body = []
    while i < len(lines) and (not lines[i].strip()
                              or _indent(lines[i]) > parent):
        body.append(lines[i])
        i += 1
    while body and not body[-1].strip() and chomp != '+':
        body.pop()
    content = [ln for ln in body if ln.strip()]
    ind = min((_indent(ln) for ln in content), default=0)
    rows = [ln[ind:] if ln.strip() else '' for ln in body]
    sep = '\n' if style == '|' else ' '
    text = sep.join(rows)
    if chomp != '-' and rows:
        text += '\n'
    return text, i


def _value(rest: str, lines, i: int, parent: int):
    """The value whose text after the key (or '- ') is ``rest``; lines
    from i on may continue it.  Returns (value, next line index)."""
    tag = None
    rest = rest.strip()
    if rest.startswith('!'):
        tag, _, rest = rest.partition(' ')
        rest = rest.strip()
    if rest[:1] in ('|', '>'):
        text, i = _block_scalar(_strip_comment(rest), lines, i, parent)
        return _tagged(tag or '!!str', text, True) if tag else text, i
    if rest[:1] in ("'", '"'):
        end = _quoted_end(rest)
        if _strip_comment(rest[end:]):
            raise ValueError(f"text after a quoted scalar: {rest!r}")
        return _tagged(tag, _unquote(rest[:end]), True), i
    if rest.startswith('['):
        inner = _strip_comment(rest)
        if not inner.endswith(']'):
            raise ValueError(f"flow sequence over several lines: {rest!r}")
        items = [x.strip() for x in inner[1:-1].split(',') if x.strip()]
        return [_value(x, [], 0, parent)[0] for x in items], i
    if rest.startswith('{'):
        raise ValueError("nested mappings are not scalar files")
    text = _strip_comment(rest)
    # a plain scalar may continue on more indented lines (folded by spaces)
    while i < len(lines) and lines[i].strip() \
            and _indent(lines[i]) > parent \
            and not lines[i].lstrip().startswith('#'):
        text = (text + ' ' + _strip_comment(lines[i].strip())).strip()
        i += 1
    return _tagged(tag, text, False), i


def loads_scalars(text: str) -> dict:
    """The mapping of a scalar YAML document (see the module docstring)."""
    lines = [ln.rstrip('\r') for ln in text.split('\n')]
    i, out = 0, {}
    while i < len(lines):
        raw = lines[i]
        i += 1
        s = raw.strip()
        if not s or s.startswith('#') or s.startswith('%'):
            continue
        if s.startswith('---'):
            doc = s[3:].strip()
            if doc and doc.split()[0] not in ('!Parameters', '!Solution'):
                raise ValueError(f"unexpected document tag {doc!r}")
            continue
        if s == '...':
            break
        if s == '{}' and not out:
            continue
        if _indent(raw):
            raise ValueError(f"unexpected indented line: {raw!r}")
        m = _KEY.match(raw)
        if m is None:
            raise ValueError(f"expected 'key: value', got {raw!r}")
        key = m.group('key')
        key = _unquote(key) if key[:1] in ("'", '"') else key
        rest = (m.group('rest') or '').strip()
        if _strip_comment(rest) and not rest.startswith('#'):
            out[key], i = _value(rest, lines, i, 0)
            continue
        # a block sequence (indentless or indented) or a null value
        seq = []
        while i < len(lines):
            nxt = lines[i].strip()
            if not nxt or nxt.startswith('#'):
                i += 1
                continue
            if not (nxt == '-' or nxt.startswith('- ')):
                break
            item_indent = _indent(lines[i])
            i += 1
            v, i = _value(nxt[1:].strip() or '~', lines, i, item_indent)
            seq.append(v)
        out[key] = seq if seq else None
    return out


def import_scalars(fname: str) -> dict:
    with open(fname, 'r') as f:
        data = loads_scalars(f.read())
    if not isinstance(data, dict):
        raise ValueError(f"{fname}: expected a YAML mapping")
    return data
