"""RFC3164 (legacy syslog) encoder.

Parity model: flowgger src/flowgger/encoder/rfc3164_encoder.rs:28-97.
``[prepend-ts][<pri>]Mon  d hh:mm:ss hostname appname[procid]: msgid sd msg``
— pri only when both facility and severity are present; timestamp from
the integer part of record.ts; structured data appended even though it is
not part of RFC3164.
"""

from __future__ import annotations

from . import Encoder, EncodeError, build_prepend_ts, config_get_prepend_ts
from ..config import Config
from ..record import Record
from ..utils.timeparse import format_rfc3164_header_ts


class RFC3164Encoder(Encoder):
    def __init__(self, config: Config):
        self.header_time_format = config_get_prepend_ts(config)

    def encode(self, record: Record) -> bytes:
        out = []
        if self.header_time_format is not None:
            out.append(build_prepend_ts(self.header_time_format))
        if record.facility is not None and record.severity is not None:
            npri = ((record.facility << 3) & 0xF8) + (record.severity & 0x7)
            out.append(f"<{npri}>")
        try:
            out.append(format_rfc3164_header_ts(record.ts))
        except (ValueError, OverflowError):
            raise EncodeError("Failed to parse unix timestamp in RFC3164 encoder")
        out.append(record.hostname)
        out.append(" ")
        if record.appname is not None:
            out.append(record.appname)
        if record.procid is not None:
            out.append(f"[{record.procid}]:")
            out.append(" ")
        if record.msgid is not None:
            out.append(record.msgid)
            out.append(" ")
        if record.sd is not None:
            for sd in record.sd:
                out.append(sd.to_string())
            out.append(" ")
        if record.msg is not None:
            out.append(record.msg)
        return "".join(out).encode("utf-8")
