r"""Scalar RFC5424 decoder.

Parity model: flowgger src/flowgger/decoder/rfc5424_decoder.rs:17-242.
Line shape: ``<PRI>1 TS HOST APP PROCID MSGID SD [msg]`` where SD is ``-``
or one or more ``[id k="v" ...]`` blocks.  Semantics preserved exactly:

- optional UTF-8 BOM before ``<`` (rs:57-72); otherwise the line must
  start with ``<``;
- the header is split on the first six spaces (``splitn(7, ' ')``), so
  empty fields between doubled spaces are possible and faithful;
- PRI is a u8 (0..=255), version must be the literal ``1``;
- SD pair names gain a ``_`` prefix; values unescape ``\"``, ``\\`` and
  ``\]`` only, any other ``\x`` stays verbatim (rs:105-125);
- ``msg`` is the whitespace-trimmed remainder, None when empty;
- ``full_msg`` is the whole line (after BOM strip) with trailing
  whitespace removed.

This scalar form doubles as the specification for the columnar kernel in
flowgger_tpu/tpu/rfc5424.py; the differential test in
tests/test_tpu_rfc5424.py holds the two paths byte-identical.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import DecodeError, Decoder
from ..record import Record, SDValue, StructuredData
from ..utils.timeparse import rfc3339_to_unix

_SD_NAME_EXCLUDED = {" ", '"', "=", "]"}


def _is_sd_name_char(c: str) -> bool:
    o = ord(c)
    return 33 <= o <= 126 and c not in _SD_NAME_EXCLUDED


def _unescape_sd_value(value: str) -> str:
    if "\\" not in value:
        return value
    out = []
    esc = False
    for c in value:
        if esc:
            if c in ('"', "\\", "]"):
                out.append(c)
            else:
                out.append("\\")
                out.append(c)
            esc = False
        elif c == "\\":
            esc = True
        else:
            out.append(c)
    if esc:
        out.append("\\")  # unreachable for well-formed values (closing quote)
    return "".join(out)


def _parse_pri_version(field: str) -> Tuple[int, int]:
    if not field.startswith("<"):
        raise DecodeError("The priority should be inside brackets")
    end = field.find(">", 1)
    if end < 0:
        raise DecodeError("Missing version")
    pri_s = field[1:end]
    if not pri_s.isdigit() or not pri_s.isascii():
        raise DecodeError("Invalid priority")
    pri = int(pri_s)
    if pri > 255:
        raise DecodeError("Invalid priority")
    if field[end + 1:] != "1":
        raise DecodeError("Unsupported version")
    return pri >> 3, pri & 7


def _parse_msg(line: str, offset: int) -> Optional[str]:
    if offset > len(line):
        return None
    m = line[offset:].strip()
    return m if m else None


def _parse_sd_block(sd: str) -> Tuple[Optional[int], List[Tuple[str, SDValue]]]:
    """Parse the interior of one SD element after its id, i.e. the text
    following ``[id ``; returns (index just past the closing ``]`` or None
    if unterminated, pairs).  State machine equivalent to rs:174-242
    including the tolerated bogus extra-quote case."""
    in_name = False
    in_value = False
    esc = False
    name_start = 0
    value_start = 0
    name: Optional[str] = None
    res_pairs: List[Tuple[str, SDValue]] = []
    after: Optional[int] = None

    for i, c in enumerate(sd):
        if in_value:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_value = False
                assert name is not None
                res_pairs.append(
                    ("_" + name, SDValue.string(_unescape_sd_value(sd[value_start:i])))
                )
                name = None
        elif in_name:
            if c == "=":
                name = sd[name_start:i]
                in_name = False
            elif _is_sd_name_char(c):
                pass
            else:
                raise DecodeError("Format error in the structured data")
        elif name is not None:
            # between '=' and the opening quote only '"' is legal
            if c == '"':
                in_value = True
                value_start = i + 1
            else:
                raise DecodeError("Format error in the structured data")
        else:
            if c == " ":
                continue
            if c == "]":
                after = i + 1
                break
            if c == '"':
                continue  # tolerate bogus entries with an extra quote
            if _is_sd_name_char(c):
                in_name = True
                name_start = i
            else:
                raise DecodeError("Format error in the structured data")
    return after, res_pairs


def _parse_sd_data(line: str, offset: int) -> Tuple[StructuredData, str, int]:
    rest = line[offset:]
    sp = rest.find(" ")
    if sp < 0:
        raise DecodeError("Missing structured data")
    sd_id, sd = rest[:sp], rest[sp + 1:]
    after, pairs = _parse_sd_block(sd)
    if after is None:
        raise DecodeError("Missing ] after structured data")
    elem = StructuredData(sd_id)
    elem.pairs = pairs
    return elem, sd, after


def _parse_data(line: str) -> Tuple[List[StructuredData], Optional[str]]:
    if not line:
        raise DecodeError("Missing log message")
    sd_vec: List[StructuredData] = []
    c0 = line[0]
    if c0 == "-":
        return sd_vec, _parse_msg(line, 1)
    if c0 != "[":
        raise DecodeError("Malformated RFC5424 message")
    leftover, offset = line, 0
    while True:
        sd, leftover, offset = _parse_sd_data(leftover, offset + 1)
        sd_vec.append(sd)
        if offset >= len(leftover):
            raise DecodeError("Missing log message")
        nxt = leftover[offset]
        if nxt == "[":
            continue
        if nxt == " ":
            return sd_vec, _parse_msg(leftover, offset)
        raise DecodeError("Malformated RFC5424 message")


class RFC5424Decoder(Decoder):
    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        if line.startswith("\ufeff"):
            line = line[1:]
        elif not line.startswith("<"):
            raise DecodeError("Unsupported BOM")
        parts = line.split(" ", 6)
        if len(parts) < 7:
            needed = ("Missing priority and version", "Missing timestamp",
                      "Missing hostname", "Missing application name",
                      "Missing process id", "Missing message id",
                      "Missing message data")
            raise DecodeError(needed[len(parts)])
        facility, severity = _parse_pri_version(parts[0])
        try:
            ts = rfc3339_to_unix(parts[1])
        except ValueError:
            raise DecodeError(
                "Unable to parse the date from RFC3339 to Unix time in RFC5424 decoder"
            )
        hostname, appname, procid, msgid = parts[2], parts[3], parts[4], parts[5]
        sd_vec, msg = _parse_data(parts[6])
        return Record(
            ts=ts,
            hostname=hostname,
            facility=facility,
            severity=severity,
            appname=appname,
            procid=procid,
            msgid=msgid,
            msg=msg,
            full_msg=line.rstrip(),
            sd=sd_vec if sd_vec else None,
        )
