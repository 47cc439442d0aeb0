"""Encoders: Record → output bytes.

Parity model: flowgger src/flowgger/encoder/ — trait
``Encoder { encode(record: Record) -> Result<Vec<u8>> }``
(encoder/mod.rs:54-56).  Encode errors raise ``EncodeError``; the pipeline
drops the message and keeps going, like the reference.
"""

from __future__ import annotations

from ..config import Config
from ..record import Record
from ..utils.timeparse import format_time_description

# encoder/mod.rs:31
SYSLOG_PREPEND_DEFAULT_TIME_FORMAT = "[year][month][day]T[hour][minute][second]Z"


class EncodeError(Exception):
    pass


class Encoder:
    def encode(self, record: Record) -> bytes:
        raise NotImplementedError


def validate_time_format_input(name: str, time_format: str, default: str) -> str:
    """Warn-and-default for legacy chrono-style ``%`` formats
    (mod.rs:372-393); escaped ``\\%`` passes through as a literal ``%``."""
    import sys

    if time_format.count("%") != time_format.count("\\%"):
        print(
            f"WARNING: Wrong {name} value received: {time_format}.\n"
            'From version "0.3.0" forward the time format needs to be compliant with:\n'
            "https://docs.rs/time/0.3.7/time/format_description/index.html \n"
            f"Will use the default one: {default}. "
            "If you want to use %, you need to escape it (\\\\%)\n",
            file=sys.stderr,
        )
        return default
    return time_format.replace("\\%", "%")


def config_get_prepend_ts(config: Config):
    """output.syslog_prepend_timestamp handling (encoder/mod.rs:58-81)."""
    fmt = config.lookup_str(
        "output.syslog_prepend_timestamp",
        "output.syslog_prepend_timestamp should be a string",
    )
    if fmt is None:
        return None
    return validate_time_format_input(
        "syslog_prepend_timestamp", fmt, SYSLOG_PREPEND_DEFAULT_TIME_FORMAT
    )


def build_prepend_ts(fmt: str) -> str:
    """Render the prepend header for *now* (encoder/mod.rs:83-94)."""
    try:
        return format_time_description(fmt)
    except ValueError:
        raise EncodeError("Failed to format date")


from .gelf import GelfEncoder  # noqa: E402
from .ltsv import LTSVEncoder  # noqa: E402
from .rfc5424 import RFC5424Encoder  # noqa: E402
from .rfc3164 import RFC3164Encoder  # noqa: E402
from .passthrough import PassthroughEncoder  # noqa: E402
from .capnp import CapnpEncoder  # noqa: E402

__all__ = [
    "Encoder",
    "EncodeError",
    "GelfEncoder",
    "LTSVEncoder",
    "RFC5424Encoder",
    "RFC3164Encoder",
    "PassthroughEncoder",
    "CapnpEncoder",
    "config_get_prepend_ts",
    "build_prepend_ts",
    "validate_time_format_input",
    "SYSLOG_PREPEND_DEFAULT_TIME_FORMAT",
]
