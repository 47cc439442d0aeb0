"""Scalar RFC3164 (legacy syslog) decoder: the exactness oracle for rows
the rfc3164 kernel flags and for lines longer than
``input.tpu_max_line_len``.

A copy of the JAX package's ``decoders/rfc3164.py``.  Parity model:
flowgger src/flowgger/decoder/rfc3164_decoder.rs:31-213.  Tries the
standard layout ``[<pri>]DATE HOST MSG`` first, then the custom
``[<pri>]HOST: DATE: MSG`` layout; both failures log the line to stderr
and surface the custom layout's error.  Dates are ``Mon d hh:mm:ss`` with
the current UTC year assumed, or ``yyyy Mon d hh:mm:ss``; a following
token naming an IANA timezone shifts the result.
"""

from __future__ import annotations

import sys

from . import DecodeError, Decoder
from ..record import Record
from ..utils.timeparse import parse_rfc3164_ts


def _parse_strip_pri(event: str):
    if event.startswith("<"):
        end = event.find(">")
        if end < 0:
            raise DecodeError("Malformed RFC3164 event: Invalid priority")
        pri_s = event[:end + 1].lstrip("<").rstrip(">")
        if not (pri_s.isdigit() and pri_s.isascii()) or int(pri_s) > 255:
            raise DecodeError("Invalid priority")
        npri = int(pri_s)
        return (npri >> 3, npri & 7), event[end + 1:]
    return (None, None), event


def _parse_date_token(tokens):
    if len(tokens) < 3:
        raise DecodeError("Invalid time format")
    try:
        ts, consumed = parse_rfc3164_ts(tokens, has_year=False)
    except ValueError:
        try:
            ts, consumed = parse_rfc3164_ts(tokens, has_year=True)
        except ValueError:
            raise DecodeError("Unable to parse the date in RFC3164 decoder")
    return ts, tokens[consumed:]


def _decode_standard(pri, msg: str, line: str) -> Record:
    tokens = msg.split()
    if len(tokens) <= 3:
        raise DecodeError("Malformed RFC3164 standard event: Invalid timestamp or hostname")
    ts, log_tokens = _parse_date_token(tokens)
    if not log_tokens:
        raise DecodeError("Malformed RFC3164 standard event: Invalid timestamp or hostname")
    hostname = log_tokens[0]
    message = " ".join(log_tokens[1:])
    return Record(
        ts=ts,
        hostname=hostname,
        facility=pri[0],
        severity=pri[1],
        msg=message,
        full_msg=line.rstrip(),
    )


def _decode_custom(pri, msg: str, line: str) -> Record:
    tokens = msg.split(": ")
    if len(tokens) <= 2:
        raise DecodeError("Malformed RFC3164 event: Invalid timestamp or hostname")
    hostname = tokens[0]
    ts, _ = _parse_date_token(tokens[1].split())
    message = ": ".join(tokens[2:])
    return Record(
        ts=ts,
        hostname=hostname,
        facility=pri[0],
        severity=pri[1],
        msg=message,
        full_msg=line.rstrip(),
    )


class RFC3164Decoder(Decoder):
    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        pri, msg = _parse_strip_pri(line)
        try:
            return _decode_standard(pri, msg, line)
        except DecodeError:
            pass
        try:
            return _decode_custom(pri, msg, line)
        except DecodeError as err:
            print(f"Unable to parse the rfc3164 input: '{line}'", file=sys.stderr)
            raise err
