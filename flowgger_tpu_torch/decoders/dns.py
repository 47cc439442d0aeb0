"""Scalar DNS query-log decoder — the byte-identity oracle for the
fixed-grammar columnar path (tpu/dns.py).

Dnstap-style text/TSV query logs (one query/response event per line),
the high-volume format arxiv 2411.12035 parses at millions of
records/sec with the same fixed-grammar columnar tricks this repo's
syslog kernels use.  Line shape — exactly six tab-separated fields:

    <ts> \\t <client> \\t <qname> \\t <qtype> \\t <rcode> \\t <latency_us>

- ``ts``: unix epoch seconds, ``digits[.digits]`` (no sign/exponent);
- ``client``: the resolver client address (→ hostname), non-empty;
- ``qname``: the query name (→ msg), non-empty;
- ``qtype``/``rcode``: mnemonic or numeric text, kept verbatim as
  string SD pairs (``_qtype``/``_rcode``);
- ``latency_us``: response latency in microseconds, decimal u64
  (→ ``_latency_us`` pair).

The ``_``-prefixed pair names follow the GELF additional-field
convention (GELF output keeps them; LTSV strips the prefix).

A copy of the JAX package's ``decoders/dns.py``, error strings included.
"""

from __future__ import annotations

from . import DecodeError, Decoder
from ..record import Record, SDValue, StructuredData

_U64_MAX = (1 << 64) - 1

PARTS_ERR = "Invalid DNS record: expected 6 tab-separated fields"
TS_ERR = "Invalid DNS record timestamp"
CLIENT_ERR = "Missing DNS client address"
QNAME_ERR = "Missing DNS query name"
LATENCY_ERR = "Invalid DNS record latency"


def _ts_valid(s: str) -> bool:
    """``digits[.digits]`` — the grammar the columnar kernel fast-paths
    (and ``float()`` parses identically for)."""
    if not s:
        return False
    head, dot, tail = s.partition(".")
    if not head.isascii() or not head.isdigit():
        return False
    if dot and (not tail or not tail.isascii() or not tail.isdigit()):
        return False
    return True


class DNSDecoder(Decoder):
    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        parts = line.split("\t")
        if len(parts) != 6:
            raise DecodeError(PARTS_ERR)
        ts_s, client, qname, qtype, rcode, lat_s = parts
        if not _ts_valid(ts_s):
            raise DecodeError(TS_ERR)
        if not client:
            raise DecodeError(CLIENT_ERR)
        if not qname:
            raise DecodeError(QNAME_ERR)
        if not (lat_s.isascii() and lat_s.isdigit()):
            raise DecodeError(LATENCY_ERR)
        latency = int(lat_s)
        if latency > _U64_MAX:
            raise DecodeError(LATENCY_ERR)
        sd = StructuredData(None)
        sd.pairs.append(("_latency_us", SDValue.u64(latency)))
        sd.pairs.append(("_qtype", SDValue.string(qtype)))
        sd.pairs.append(("_rcode", SDValue.string(rcode)))
        return Record(
            ts=float(ts_s),
            hostname=client,
            msg=qname,
            sd=[sd],
        )
