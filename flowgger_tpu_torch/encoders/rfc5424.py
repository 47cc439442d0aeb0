"""RFC5424 encoder.

Parity model: flowgger src/flowgger/encoder/rfc5424_encoder.rs:28-93.
``<pri>1 ts host appname? procid|- msgid|- sd|- msg?`` — pri defaults to
``<13>`` when facility or severity is missing; the timestamp is truncated
to milliseconds and rendered RFC3339 with trimmed subseconds; note the
reference omits appname *and its trailing space* entirely when absent.
"""

from __future__ import annotations

from . import Encoder, EncodeError
from ..record import Record
from ..utils.timeparse import unix_to_rfc3339_ms

DEFAULT_PRIORITY = "<13>"
DEFAULT_SYSLOG_VERSION = "1"


class RFC5424Encoder(Encoder):
    def __init__(self, config=None):
        pass

    def encode(self, record: Record) -> bytes:
        out = []
        if record.facility is not None and record.severity is not None:
            npri = ((record.facility << 3) & 0xF8) + (record.severity & 0x7)
            out.append(f"<{npri}>")
        else:
            out.append(DEFAULT_PRIORITY)
        out.append(DEFAULT_SYSLOG_VERSION)
        out.append(" ")
        try:
            out.append(unix_to_rfc3339_ms(record.ts))
        except (ValueError, OverflowError):
            raise EncodeError("Failed to parse date")
        out.append(" ")
        out.append(record.hostname)
        out.append(" ")
        if record.appname is not None:
            out.append(record.appname)
            out.append(" ")
        out.append(record.procid if record.procid is not None else "-")
        out.append(" ")
        out.append(record.msgid if record.msgid is not None else "-")
        out.append(" ")
        if record.sd is not None:
            for sd in record.sd:
                out.append(sd.to_string())
            out.append(" ")
        else:
            out.append("- ")
        if record.msg is not None:
            out.append(record.msg)
        return "".join(out).encode("utf-8")
