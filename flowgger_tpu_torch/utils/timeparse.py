"""Calendar math, RFC3339 parsing for the scalar RFC5424 oracle, the
BSD-syslog date parse of the scalar RFC3164 oracle, the Apache-style
date parse of the scalar LTSV oracle, the receive-time stamp of the
JSON-lines oracle, and the renderers of the syslog outputs (the
millisecond RFC3339 stamp of RFC5424, the BSD header of RFC3164 and the
``syslog_prepend_timestamp`` format description).

Behavioral model: the reference's use of the ``time`` crate — RFC3339 →
unix f64 with nanosecond precision (rfc5424_decoder.rs:94-103,
``PreciseTimestamp::from_offset_datetime`` utils/mod.rs:23-27: integer
nanos divided by 1e9 as f64).

Everything integer-sized here is kept as exact int math until the single
final float division, so results are bit-identical with the reference,
and the RFC5424 kernel (tpu/rfc5424.py) runs the identical civil-days
formula in int32 and emits the same (days, secs, nanos) decomposition.
"""

from __future__ import annotations

import time as _time
from functools import lru_cache
from typing import Optional, Tuple

MONTH_ABBR = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
_MONTH_IDX = {m: i + 1 for i, m in enumerate(MONTH_ABBR)}

_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def days_in_month(year: int, month: int) -> int:
    if month == 2 and is_leap(year):
        return 29
    return _DAYS_IN_MONTH[month - 1]


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (Howard Hinnant's civil-days algorithm —
    branch-free, so the TPU kernel runs the identical formula in int32)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _ascii_digits(s: str) -> bool:
    """Rust-style digit check: ASCII 0-9 only (str.isdigit alone accepts
    Unicode digits the reference rejects)."""
    return bool(s) and s.isascii() and s.isdigit()


def _parse_fixed_digits(s: str, start: int, n: int) -> int:
    chunk = s[start:start + n]
    if len(chunk) != n or not _ascii_digits(chunk):
        raise ValueError(f"expected {n} digits at {start}")
    return int(chunk)


def rfc3339_to_unix(s: str) -> float:
    """Parse an RFC3339 timestamp into unix seconds as f64.

    Matches ``OffsetDateTime::parse(s, &Rfc3339)`` followed by
    ``unix_timestamp_nanos() as f64 / 1e9``: date components validated,
    subseconds capped at 9 digits, offset ``Z``/``z`` or ``±hh:mm``.
    Raises ValueError on any malformation.
    """
    n = len(s)
    if n < 20:
        raise ValueError("too short")
    year = _parse_fixed_digits(s, 0, 4)
    if s[4] != "-":
        raise ValueError("bad date separator")
    month = _parse_fixed_digits(s, 5, 2)
    if s[7] != "-":
        raise ValueError("bad date separator")
    day = _parse_fixed_digits(s, 8, 2)
    if s[10] not in "Tt":
        raise ValueError("bad time separator")
    hour = _parse_fixed_digits(s, 11, 2)
    if s[13] != ":":
        raise ValueError("bad time separator")
    minute = _parse_fixed_digits(s, 14, 2)
    if s[16] != ":":
        raise ValueError("bad time separator")
    sec = _parse_fixed_digits(s, 17, 2)
    if not (1 <= month <= 12 and 1 <= day <= days_in_month(year, month)):
        raise ValueError("bad date")
    if not (hour <= 23 and minute <= 59 and sec <= 59):
        raise ValueError("bad time")
    pos = 19
    nanos = 0
    if pos < n and s[pos] == ".":
        pos += 1
        frac_start = pos
        while pos < n and "0" <= s[pos] <= "9":
            pos += 1
        ndigits = pos - frac_start
        if ndigits == 0 or ndigits > 9:
            raise ValueError("bad subsecond")
        nanos = int(s[frac_start:pos]) * 10 ** (9 - ndigits)
    if pos >= n:
        raise ValueError("missing offset")
    offset_secs = 0
    c = s[pos]
    if c in "Zz":
        if pos + 1 != n:
            raise ValueError("trailing data")
    elif c in "+-":
        if pos + 6 != n or s[pos + 3] != ":":
            raise ValueError("bad offset")
        oh = _parse_fixed_digits(s, pos + 1, 2)
        om = _parse_fixed_digits(s, pos + 4, 2)
        if oh > 23 or om > 59:
            raise ValueError("bad offset")
        offset_secs = oh * 3600 + om * 60
        if c == "-":
            offset_secs = -offset_secs
    else:
        raise ValueError("bad offset")
    days = days_from_civil(year, month, day)
    total = days * 86400 + hour * 3600 + minute * 60 + sec - offset_secs
    return (total * 1_000_000_000 + nanos) / 1e9


def civil_from_days(z: int) -> Tuple[int, int, int]:
    """(year, month, day) of day ``z`` since 1970-01-01 (Hinnant's
    inverse of :func:`days_from_civil`)."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


def unix_to_rfc3339_ms(ts: float) -> str:
    """Format unix seconds as RFC3339 after millisecond truncation —
    ``((ts*1000.) as i128)*1_000_000`` then time-crate Rfc3339 formatting
    (rfc5424_encoder.rs:43-55): subsecond printed as 9 digits with
    trailing zeros trimmed, omitted entirely when zero, UTC rendered as
    ``Z``.  The product stays a Python float64 and ``divmod`` floors, so
    ``.002`` comes out ``.001`` and pre-1970 stamps round down, as in the
    reference.
    """
    total_ns = int(ts * 1000.0) * 1_000_000
    secs, nanos = divmod(total_ns, 1_000_000_000)
    y, m, d = civil_from_days(secs // 86400)
    sod = secs % 86400
    hh, rem = divmod(sod, 3600)
    mm, ss = divmod(rem, 60)
    out = f"{y:04d}-{m:02d}-{d:02d}T{hh:02d}:{mm:02d}:{ss:02d}"
    if nanos:
        frac = f"{nanos:09d}".rstrip("0")
        out += f".{frac}"
    return out + "Z"


def format_time_description(fmt: str, ts: Optional[float] = None) -> str:
    """Render a (subset of the) time-crate format-description string —
    the config surface of ``output.syslog_prepend_timestamp``
    (encoder/mod.rs:31).

    Supported components: [year] [month] [month repr:short] [day]
    [day padding:none] [hour] [minute] [second]; literal text passes
    through.  Raises ValueError on an unknown component.
    """
    if ts is None:
        ts = now_precise()
    secs = int(ts)
    y, m, d = civil_from_days(secs // 86400)
    sod = secs % 86400
    hh, rem = divmod(sod, 3600)
    mm, ss = divmod(rem, 60)
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "[":
            out.append(c)
            i += 1
            continue
        j = fmt.find("]", i)
        if j < 0:
            raise ValueError("unterminated format component")
        comp = fmt[i + 1:j].strip()
        if comp == "year":
            out.append(f"{y:04d}")
        elif comp == "month":
            out.append(f"{m:02d}")
        elif comp == "month repr:short":
            out.append(MONTH_ABBR[m - 1])
        elif comp == "day":
            out.append(f"{d:02d}")
        elif comp == "day padding:none":
            out.append(str(d))
        elif comp == "hour":
            out.append(f"{hh:02d}")
        elif comp == "minute":
            out.append(f"{mm:02d}")
        elif comp == "second":
            out.append(f"{ss:02d}")
        else:
            raise ValueError(f"unsupported format component: [{comp}]")
        i = j + 1
    return "".join(out)


def format_rfc3164_header_ts(ts: float) -> str:
    """``[month repr:short]  [day padding:none] [hh]:[mm]:[ss] `` — note
    the double space before the unpadded day (rfc3164_encoder.rs:55-58)."""
    secs = int(ts)
    y, m, d = civil_from_days(secs // 86400)
    sod = secs % 86400
    hh, rem = divmod(sod, 3600)
    mm, ss = divmod(rem, 60)
    return f"{MONTH_ABBR[m - 1]}  {d} {hh:02d}:{mm:02d}:{ss:02d} "


def now_precise() -> float:
    """PreciseTimestamp::now (utils/mod.rs:14-21): secs + nanos/1e9."""
    ns = _time.time_ns()
    return (ns // 1_000_000_000) + (ns % 1_000_000_000) / 1e9


def current_year_utc() -> int:
    return _time.gmtime().tm_year


@lru_cache(maxsize=4096)
def _zone(tzname: str):
    """The IANA zone of that name, or None if there is none.  Cached by
    name, the misses too: every token after a BSD-syslog time is tried as
    a zone name, and a miss searches the zone paths again each time."""
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(tzname)
    except Exception:  # flowcheck: disable=FC04 -- parse contract: None means "no zoneinfo"; caller logs once
        return None


def _tz_offset_nanos(tzname: str, year: int, month: int, day: int,
                     hour: int, minute: int, sec: int) -> Optional[int]:
    """UTC offset (seconds) for an IANA zone at the given *local* wall time,
    or None if the zone name is unknown.  Mirrors time-tz
    ``assume_timezone`` (rfc3164_decoder.rs:190-209)."""
    import datetime as _dt

    tz = _zone(tzname)
    if tz is None:
        return None
    local = _dt.datetime(year, month, day, hour, minute, sec, tzinfo=tz)
    off = local.utcoffset()
    if off is None:
        return None
    return int(off.total_seconds())


def parse_rfc3164_ts(tokens, has_year: bool) -> Tuple[float, int]:
    """Parse ``[Mon] [day] [hh:mm:ss]`` (+optional leading year token when
    ``has_year``) followed by an optional IANA timezone token.

    Returns (unix_ts_f64, tokens_consumed).  Matches
    rfc3164_decoder.rs:162-213: without a year the *current UTC year* is
    assumed; a following token naming a known timezone shifts the result,
    otherwise the wall time is taken as UTC.
    """
    idx = 0
    if has_year:
        if len(tokens) < 4:
            raise ValueError("not enough tokens")
        year_s, mon_s, day_s, time_s = tokens[0], tokens[1], tokens[2], tokens[3]
        if not _ascii_digits(year_s):
            raise ValueError("bad year")
        year = int(year_s)
        idx = 4
    else:
        if len(tokens) < 3:
            raise ValueError("not enough tokens")
        year = current_year_utc()
        mon_s, day_s, time_s = tokens[0], tokens[1], tokens[2]
        idx = 3
    month = _MONTH_IDX.get(mon_s)
    if month is None:
        raise ValueError("bad month")
    if not _ascii_digits(day_s):
        raise ValueError("bad day")
    day = int(day_s)
    parts = time_s.split(":")
    if len(parts) != 3 or not all(_ascii_digits(p) for p in parts):
        raise ValueError("bad time")
    hour, minute, sec = (int(p) for p in parts)
    if not (len(parts[0]) == 2 and len(parts[1]) == 2 and len(parts[2]) == 2):
        raise ValueError("bad time field width")
    if not (1 <= day <= days_in_month(year, month)
            and hour <= 23 and minute <= 59 and sec <= 59):
        raise ValueError("bad date/time")

    days = days_from_civil(year, month, day)
    total = days * 86400 + hour * 3600 + minute * 60 + sec

    # Optional timezone token
    if idx < len(tokens):
        off = _tz_offset_nanos(tokens[idx], year, month, day, hour, minute, sec)
        if off is not None:
            return float((total - off) * 1_000_000_000 / 1e9), idx + 1
    return float(total * 1_000_000_000 / 1e9), idx


def parse_english_time(s: str) -> float:
    """Apache-style ``d/Mon/yyyy:hh:mm:ss[.frac] ±zzzz`` → unix f64
    (ltsv_decoder.rs:224-253; day has no padding, offset is mandatory
    with sign, 4-digit ``hhmm``)."""
    # split date part and offset part on the single space
    sp = s.find(" ")
    if sp < 0:
        raise ValueError("missing offset")
    dt_part, off_part = s[:sp], s[sp + 1:]
    if len(off_part) != 5 or off_part[0] not in "+-":
        raise ValueError("bad offset")
    if not _ascii_digits(off_part[1:]):
        raise ValueError("bad offset")
    oh, om = int(off_part[1:3]), int(off_part[3:5])
    offset = oh * 3600 + om * 60
    if off_part[0] == "-":
        offset = -offset

    comps = dt_part.split(":")
    if len(comps) != 4:
        raise ValueError("bad datetime")
    date_s, hh_s, mm_s, ss_s = comps
    dmy = date_s.split("/")
    if len(dmy) != 3:
        raise ValueError("bad date")
    day_s, mon_s, year_s = dmy
    if not (_ascii_digits(day_s) and _ascii_digits(year_s)):
        raise ValueError("bad date")
    month = _MONTH_IDX.get(mon_s)
    if month is None:
        raise ValueError("bad month")
    day, year = int(day_s), int(year_s)
    nanos = 0
    if "." in ss_s:
        sec_s, frac_s = ss_s.split(".", 1)
        if not (_ascii_digits(frac_s) and 1 <= len(frac_s) <= 9):
            raise ValueError("bad subsecond")
        nanos = int(frac_s) * 10 ** (9 - len(frac_s))
    else:
        sec_s = ss_s
    if not (_ascii_digits(hh_s) and _ascii_digits(mm_s)
            and _ascii_digits(sec_s)):
        raise ValueError("bad time")
    hour, minute, sec = int(hh_s), int(mm_s), int(sec_s)
    if not (1 <= month <= 12 and 1 <= day <= days_in_month(year, month)
            and hour <= 23 and minute <= 59 and sec <= 59):
        raise ValueError("bad date/time")
    days = days_from_civil(year, month, day)
    total = days * 86400 + hour * 3600 + minute * 60 + sec - offset
    return (total * 1_000_000_000 + nanos) / 1e9
