"""ctypes bindings for the port's native host tier
(``flowgger_tpu_torch/csrc/flowgger_host.cpp``, a trimmed copy of the
JAX package's C++ host library).

Exports and their callers:

- ``fg_gelf_lens_v2`` / ``fg_gelf_write_v2`` — the GELF row engine of
  ``tpu/encode_gelf_block``;
- ``fg_r5_lens`` / ``fg_r5_write`` — the RFC5424 row writer of
  ``tpu/encode_rfc5424_block`` (rfc5424 → RFC5424);
- ``fg_concat_segments`` — the segment gather of
  ``tpu/assemble.concat_segments`` (both block encoders, the escape view
  and the device tier's splice);
- ``fg_format_f64_json`` — the timestamp text of
  ``tpu/device_common.ts_text_block``;
- ``fg_crc32c`` — the CRC32C of a Kafka record batch v2
  (``utils/kafka_wire._record_batch``);
- ``fg_snappy_max_compressed`` / ``fg_snappy_compress`` /
  ``fg_snappy_decompress`` — the snappy block codec of
  ``utils/snappy.py`` (record batches with ``kafka_compression =
  "snappy"``).

The source is compiled with ``g++`` (the flags of the JAX package's
``native/Makefile``) into ``build/host`` next to the package at first
call, never at import, keyed by a hash of the source and the flags;
the compile writes a temporary name and publishes it with
``os.replace``, so concurrent first calls (threads or test workers) at
worst compile twice.  Unlike the JAX package, whose wrappers return
None and fall back to numpy, nothing here degrades: no ``g++`` or a
failed build raises ``RuntimeError`` with the compiler's output, and the
wrappers never return None.  The numpy and Python versions stay beside
their callers as the plain versions the tests hold these against.

:data:`CALLS` counts the calls of each export since
:func:`reset_calls`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "flowgger_host.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall")
_DEFAULT_THREADS = min(8, os.cpu_count() or 1)
MAX_PAIRS = 64   # kMaxPairs in flowgger_host.cpp: the row engine's pair cap

# calls of each export since the last reset_calls()
CALLS: Dict[str, int] = {
    "fg_gelf_lens_v2": 0, "fg_gelf_write_v2": 0, "fg_r5_lens": 0,
    "fg_r5_write": 0, "fg_concat_segments": 0, "fg_format_f64_json": 0,
    "fg_crc32c": 0, "fg_snappy_compress": 0, "fg_snappy_decompress": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_INT = ctypes.c_int
_GELF_COMMON = [_P, _P, _I64, _P, _P, _P, _P, _P, _I32, _P, _P, _I32, _I32]
# fg_r5_lens / fg_r5_write: chunk, meta, R, sid_s, sid_e, SD, the five
# [R, P] pair tables, P, ts scratch, suffix, its length, syslen
_R5_COMMON = [_P, _P, _I64, _P, _P, _I32, _P, _P, _P, _P, _P, _I32, _P, _P,
              _I32, _I32]
_SIGNATURES = {
    "fg_gelf_lens_v2": (None, _GELF_COMMON + [_P, _INT]),
    "fg_r5_lens": (None, _R5_COMMON + [_P, _INT]),
    "fg_r5_write": (None, _R5_COMMON + [_P, _P, _INT]),
    "fg_gelf_write_v2": (None, _GELF_COMMON + [_P, _P, _INT]),
    "fg_concat_segments": (None, [_P, _P, _P, _P, _I64, _P, _INT]),
    "fg_format_f64_json": (None, [_P, _I64, _P, _I32, _P, _INT]),
    "fg_crc32c": (ctypes.c_uint32, [_P, _I64, ctypes.c_uint32]),
    "fg_snappy_max_compressed": (_I64, [_I64]),
    "fg_snappy_compress": (_I64, [_P, _I64, _P]),
    "fg_snappy_decompress": (_I64, [_P, _I64, _P, _I64]),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_calls() -> None:
    with _count_lock:
        for name in CALLS:
            CALLS[name] = 0


def _called(name: str) -> None:
    # the lanes' fetcher threads call the engine at once
    with _count_lock:
        CALLS[name] += 1


def build_dir() -> Path:
    return _SRC.parent.parent.parent / "build" / "host"


def _cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found: the native host tier of "
                           "flowgger_tpu_torch (csrc/flowgger_host.cpp) is "
                           "built from source at first use and needs a C++17 "
                           "compiler")
    return found


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"flowgger_host-{h}.so"


def build() -> dict:
    """Compile the library unless it is built.  Returns ``{"path",
    "cached", "seconds", "compiler", "version", "flags"}``; raises
    RuntimeError with the compiler's output if the build fails."""
    cxx = _cxx()
    dst = _lib_path()
    info = {"path": str(dst), "compiler": cxx, "flags": " ".join(CXX_FLAGS)}
    ver = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60)
    info["version"] = (ver.stdout.splitlines() or [""])[0]
    if dst.exists():
        return {**info, "cached": True, "seconds": 0.0}
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host tier build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, dst)
    return {**info, "cached": False, "seconds": time.perf_counter() - t0}


def _load() -> ctypes.CDLL:
    lib = _lib
    if lib is not None:
        return lib
    # the compile runs outside the lock (builds publish atomically); only
    # the load and the binding are locked
    path = build()["path"]
    return _bind(path)


def _bind(path: str) -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            for fn, (res, args) in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _lib = lib
        return _lib


def gelf_rows_available() -> bool:
    """True once the library is loaded (loading raises otherwise): the
    GELF block encoder's engine choice, which its numpy-engine tests
    patch to False."""
    _load()
    return True


def gelf_rows_native(chunk: bytes, meta: np.ndarray,
                     pns: np.ndarray, pne: np.ndarray,
                     pvs: np.ndarray, pve: np.ndarray, pesc: np.ndarray,
                     ts_scratch: bytes, suffix: bytes, syslen: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(framed buffer u8, row offsets int64[R + 1])`` of the GELF rows
    described by ``meta`` (``[R, 17]`` int32, the column order of
    flowgger_host.cpp's ``M_*`` enum; spans row-relative into ``chunk``)
    and the ``[R, P]`` pair tables: name and value spans and the flags
    of values that need the SD unescape.  Each row carries its framing
    suffix, and with ``syslen`` its length prefix."""
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    R = meta.shape[0]
    P = pns.shape[1] if pns.ndim == 2 else 0
    tables = [np.ascontiguousarray(a, dtype=np.int32)
              for a in (pns, pne, pvs, pve, pesc)]
    if meta.ndim != 2 or meta.shape[1] != 17 or any(
            t.shape != (R, P) for t in tables):
        raise ValueError(f"GELF rows: meta {meta.shape} and pair tables "
                         f"{[t.shape for t in tables]} disagree")
    pns, pne, pvs, pve, pesc = tables
    _check_gelf_spans(len(chunk), len(ts_scratch), meta, pns, pne, pvs, pve)
    lib = _load()
    cbuf = np.frombuffer(chunk, dtype=np.uint8)
    tbuf = np.frombuffer(ts_scratch or b"\0", dtype=np.uint8)
    sbuf = np.frombuffer(suffix or b"\0", dtype=np.uint8)
    lens = np.empty(R, dtype=np.int64)
    args = (cbuf.ctypes.data, meta.ctypes.data, R, pns.ctypes.data,
            pne.ctypes.data, pvs.ctypes.data, pve.ctypes.data,
            pesc.ctypes.data, P, tbuf.ctypes.data, sbuf.ctypes.data,
            len(suffix), 1 if syslen else 0)
    _called("fg_gelf_lens_v2")
    lib.fg_gelf_lens_v2(*args, lens.ctypes.data, _DEFAULT_THREADS)
    off = np.empty(R + 1, dtype=np.int64)
    off[0] = 0
    np.cumsum(lens, out=off[1:])
    out = np.empty(int(off[-1]), dtype=np.uint8)
    _called("fg_gelf_write_v2")
    lib.fg_gelf_write_v2(*args, off.ctypes.data, out.ctypes.data,
                         _DEFAULT_THREADS)
    return out, off


def r5_rows_available() -> bool:
    """True once the library is loaded (loading raises otherwise): the
    RFC5424 block encoder's engine choice, which its numpy-engine tests
    patch to False."""
    _load()
    return True


def r5_rows_native(chunk: bytes, meta: np.ndarray,
                   sid_s: np.ndarray, sid_e: np.ndarray,
                   pns: np.ndarray, pne: np.ndarray,
                   pvs: np.ndarray, pve: np.ndarray, psd: np.ndarray,
                   ts_scratch: bytes, suffix: bytes, syslen: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(framed buffer u8, row offsets int64[R + 1])`` of the RFC5424
    re-encode tier rows (``fg_r5_lens`` / ``fg_r5_write``): ``meta`` is
    ``[R, 16]`` int32 in the column order of flowgger_host.cpp's
    ``R5_*`` enum (spans row-relative into ``chunk``), the SD tables
    ``[R, SD]``, the pair tables ``[R, P]`` with ``psd`` each pair's block
    ordinal (pairs of one block adjacent, blocks in order, as the rfc5424
    decode attributes them)."""
    lib = _load()
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    R = meta.shape[0]
    SD = sid_s.shape[1] if sid_s.size else 0
    P = pns.shape[1] if pns.size else 0
    sid_s, sid_e, pns, pne, pvs, pve, psd = [
        np.ascontiguousarray(a, dtype=np.int32)
        for a in (sid_s, sid_e, pns, pne, pvs, pve, psd)]
    if R and (int(meta[:, 12].max()) > SD or int(meta[:, 13].max()) > P):
        raise ValueError("fg_r5 rows: an SD or pair count exceeds its table")
    cbuf = np.frombuffer(chunk, dtype=np.uint8)
    tbuf = np.frombuffer(ts_scratch or b"\0", dtype=np.uint8)
    sbuf = np.frombuffer(suffix or b"\0", dtype=np.uint8)
    lens = np.empty(R, dtype=np.int64)
    args = (cbuf.ctypes.data, meta.ctypes.data, R,
            sid_s.ctypes.data, sid_e.ctypes.data, SD,
            pns.ctypes.data, pne.ctypes.data, pvs.ctypes.data,
            pve.ctypes.data, psd.ctypes.data, P,
            tbuf.ctypes.data, sbuf.ctypes.data, len(suffix),
            1 if syslen else 0)
    lib.fg_r5_lens(*args, lens.ctypes.data, _DEFAULT_THREADS)
    _called("fg_r5_lens")
    off = np.empty(R + 1, dtype=np.int64)
    off[0] = 0
    np.cumsum(lens, out=off[1:])
    out = np.empty(int(off[-1]), dtype=np.uint8)
    lib.fg_r5_write(*args, off.ctypes.data, out.ctypes.data,
                    _DEFAULT_THREADS)
    _called("fg_r5_write")
    return out, off


def _check_gelf_spans(chunk_len: int, ts_len: int, meta: np.ndarray,
                      pns, pne, pvs, pve) -> None:
    """Raise unless every span the engine reads lies inside its buffer
    with its end at or past its start, and every row's pair count fits
    the pair tables and the engine's kMaxPairs stack table."""
    R, P = pns.shape
    if not R:
        return
    npair = meta[:, 16]
    if P > MAX_PAIRS or int(npair.min()) < 0 or int(npair.max()) > P:
        raise ValueError(f"GELF rows: pair counts outside [0, {P}] or a "
                         f"table wider than the engine's {MAX_PAIRS}")
    live = np.arange(P)[None, :] < npair[:, None]
    # the row's spans: host, app, proc and the full message (whose end
    # the message shares; the message itself is read only when it ends
    # past its start) always, the SD id only in rows with structured
    # data (M_NSD)
    has_sd = meta[:, 11:12] != 0
    sid = np.where(has_sd, meta[:, 12:14], 0)
    reversed_ = (any((meta[:, e] < meta[:, s]).any()
                     for s, e in ((1, 2), (3, 4), (5, 6), (9, 8)))
                 or (sid[:, 1] < sid[:, 0]).any()
                 or (live & (pne < pns)).any() or (live & (pve < pvs)).any())
    if reversed_:
        raise ValueError("GELF rows: a span ends before its start")
    lo = min(int(meta[:, :10].min()), int(sid.min()),
             int(pns.min(initial=0, where=live)),
             int(pvs.min(initial=0, where=live)))
    ends = np.maximum.reduce([
        meta[:, 1:10].max(axis=1), sid.max(axis=1),
        pne.max(axis=1, initial=0, where=live),
        pve.max(axis=1, initial=0, where=live)])
    ts_end = meta[:, 14].astype(np.int64) + meta[:, 15]
    if (lo < 0 or int((meta[:, 0].astype(np.int64) + ends).max()) > chunk_len
            or int(meta[:, 14].min()) < 0 or int(meta[:, 15].min()) < 0
            or int(ts_end.max()) > ts_len):
        raise ValueError("GELF rows: a span lies outside the chunk or the "
                         "timestamp scratch")


def concat_segments_native(src: np.ndarray, seg_src: np.ndarray,
                           seg_len: np.ndarray, dst_off: np.ndarray,
                           total: int) -> np.ndarray:
    """``src[seg_src[i] : seg_src[i] + seg_len[i]]`` for every i,
    concatenated into ``total`` bytes; ``dst_off`` is the exclusive
    prefix sum of ``seg_len`` (threaded memcpy)."""
    seg_src = np.ascontiguousarray(seg_src, dtype=np.int64)
    seg_len = np.ascontiguousarray(seg_len, dtype=np.int64)
    dst_off = np.ascontiguousarray(dst_off, dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.uint8)
    nseg = seg_src.size
    if seg_len.size != nseg or dst_off.size < nseg:
        raise ValueError(f"concat of {nseg} segments: {seg_len.size} "
                         f"lengths, {dst_off.size} offsets")
    out = np.empty(total, dtype=np.uint8)
    if nseg:
        # every segment the copy reads and writes lies inside its buffer
        live = seg_len > 0
        dst = dst_off[:nseg]
        if (int(seg_len.min()) < 0
                or int(seg_src.min(initial=0, where=live)) < 0
                or int((seg_src + seg_len).max(initial=0, where=live))
                > src.size
                or int(dst.min(initial=0, where=live)) < 0
                or int((dst + seg_len).max(initial=0, where=live)) > total):
            raise ValueError(f"concat of {nseg} segments from {src.size} "
                             f"into {total} bytes: a segment lies outside")
        lib = _load()
        _called("fg_concat_segments")
        lib.fg_concat_segments(src.ctypes.data, seg_src.ctypes.data,
                               seg_len.ctypes.data, dst_off.ctypes.data,
                               nseg, out.ctypes.data, _DEFAULT_THREADS)
    return out


def format_f64_json_native(vals: np.ndarray, width: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """serde_json text (``utils.rustfmt.json_f64``) of each f64: dense
    ``[n, width]`` u8 rows, zero-padded, and int32 lengths; a text
    longer than ``width`` gets length 0 and a zero row."""
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n = vals.size
    txt = np.empty((n, width), dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    if n:
        lib = _load()
        _called("fg_format_f64_json")
        lib.fg_format_f64_json(vals.ctypes.data, n, txt.ctypes.data, width,
                               lens.ctypes.data, _DEFAULT_THREADS)
    return txt, lens


def crc32c(data: bytes, init: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``init``: the
    checksum of a Kafka record batch v2."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    _called("fg_crc32c")
    return int(lib.fg_crc32c(buf.ctypes.data if len(data) else None,
                             len(data), init))


def snappy_compress(data: bytes) -> bytes:
    """``data`` as one raw snappy block (greedy 64 KiB-block hash
    matching)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(int(lib.fg_snappy_max_compressed(len(data))),
                   dtype=np.uint8)
    _called("fg_snappy_compress")
    n = lib.fg_snappy_compress(src.ctypes.data if len(data) else None,
                               len(data), dst.ctypes.data)
    return dst[:n].tobytes()


def snappy_decompress(data: bytes, ulen: int) -> Optional[bytes]:
    """The ``ulen`` bytes a raw snappy block holds (``ulen`` from its
    preamble), or None when the block is malformed."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max(ulen, 1), dtype=np.uint8)
    _called("fg_snappy_decompress")
    n = lib.fg_snappy_decompress(src.ctypes.data if len(data) else None,
                                 len(data), dst.ctypes.data, ulen)
    return None if n < 0 else dst[:n].tobytes()
