"""Materialize the JSON-lines structural index into Records, and the
scalar oracle the block encoder re-runs on rows it does not take.

Stage 2 of the simdjson-style split: token spans → Python values.  Key
routing is the oracle's own (decoders/jsonl.py ``route_obj``): duplicate
keys keep the last value, keys iterate in *sorted* order, and the
specials timestamp/host/message/level validate with the same messages.
Escaped strings, numbers and nested-container spans parse with
``json.loads`` on the token span, so edge cases (\\u escapes, leading
zeros, huge exponents, malformed nested JSON) behave exactly like the
oracle's whole-line parse.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..decoders import DecodeError
from ..decoders.jsonl import JSONLDecoder, PARSE_ERR, route_obj
from .jsonidx import (VT_ARRAY, VT_FALSE, VT_NULL, VT_NUMBER, VT_OBJECT,
                      VT_STRING, VT_TRUE)
from .materialize import LineResult

_SCALAR = JSONLDecoder()


def materialize_jsonl(chunk_bytes: bytes, starts: np.ndarray,
                      orig_lens: np.ndarray, out: Dict[str, np.ndarray],
                      n_real: int, max_len: int) -> List[LineResult]:
    """One LineResult per row: spans for rows the index accepted, the
    scalar oracle for flagged and over-length rows."""
    out = {k: np.asarray(v).tolist() for k, v in out.items()}
    ok = out["ok"]
    results: List[LineResult] = []
    for n in range(n_real):
        s = int(starts[n])
        ln = int(orig_lens[n])
        raw = chunk_bytes[s:s + ln]
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            results.append(LineResult(None, "__utf8__", ""))
            continue
        if not ok[n] or ln > max_len:
            results.append(_scalar_jsonl(line))
            continue
        results.append(_from_spans(line, raw, len(line) == ln, n, out))
    return results


def _scalar_jsonl(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)


def _from_spans(line: str, raw: bytes, byte_ok: bool, n: int,
                o: Dict[str, list]) -> LineResult:
    def take(a: int, b: int) -> str:
        if byte_ok:
            return line[a:b]
        return raw[a:b].decode("utf-8")

    obj = {}
    try:
        for k in range(int(o["n_fields"][n])):
            ks, ke = int(o["key_start"][n][k]), int(o["key_end"][n][k])
            key = take(ks, ke)
            if o["key_esc"][n][k]:
                key = json.loads(f'"{key}"')
            elif any(ord(c) < 0x20 for c in key):
                raise ValueError("control char")
            vt = int(o["val_type"][n][k])
            vs, ve = int(o["val_start"][n][k]), int(o["val_end"][n][k])
            if vt == VT_STRING:
                value = take(vs, ve)
                if o["val_esc"][n][k]:
                    value = json.loads(f'"{value}"')
                elif any(ord(c) < 0x20 for c in value):
                    raise ValueError("control char")  # oracle rejects too
            elif vt == VT_NUMBER:
                value = json.loads(take(vs, ve))
            elif vt == VT_TRUE:
                value = True
            elif vt == VT_FALSE:
                value = False
            elif vt == VT_NULL:
                value = None
            elif vt in (VT_OBJECT, VT_ARRAY):
                # the container's exact span; json.loads applies the
                # whole-line parse's own rules to just these bytes
                value = json.loads(take(vs, ve))
            else:
                raise ValueError("bad token")
            obj[key] = value  # duplicates: last wins, like json.loads
    except (ValueError, json.JSONDecodeError):
        return LineResult(None, PARSE_ERR, line)
    try:
        record = route_obj(obj)
    except DecodeError as e:
        return LineResult(None, str(e), line)
    return LineResult(record, None, line)
