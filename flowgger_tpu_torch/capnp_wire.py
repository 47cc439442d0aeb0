"""Cap'n Proto wire format for the fixed ``record.capnp`` schema: the
writer and the reader.

A copy of the JAX package's ``capnp_wire.py``, writer and reader: single-
segment messages holding one ``Record`` struct (2 data words + 9
pointers) with ``Pair`` composite lists (2 data words + 2 pointers, value
union discriminant at data u16[0], bool at bit 16, f64/i64/u64 at data
word 1), byte-identical with capnp's bump allocator for the reference's
allocation order (capnp_encoder.rs:45-106).  Union discriminants:
string=0 bool=1 f64=2 i64=3 u64=4 null=5 (record_capnp.rs:858-894).

Framing (``capnp::serialize::write_message``): u32 little-endian segment
count minus one, u32 sizes per segment, then the raw segment.  The reader
half (``parse_message``, ``RecordReader``) serves the capnp input
(``splitters.CapnpSplitter``).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .record import (
    FACILITY_MISSING,
    Record,
    SDValue,
    SEVERITY_MISSING,
)

WORD = 8

# Record struct layout (record_capnp.rs:481-483)
RECORD_DATA_WORDS = 2
RECORD_PTR_WORDS = 9
# data fields
_TS_OFF = 0        # f64 at data byte 0
_FACILITY_OFF = 8  # u8
_SEVERITY_OFF = 9  # u8
# pointer slots
_P_HOSTNAME, _P_APPNAME, _P_PROCID, _P_MSGID = 0, 1, 2, 3
_P_MSG, _P_FULL_MSG, _P_SD_ID, _P_PAIRS, _P_EXTRA = 4, 5, 6, 7, 8

PAIR_DATA_WORDS = 2
PAIR_PTR_WORDS = 2
_UNION_DISCRIMINANTS = {
    SDValue.STRING: 0,
    SDValue.BOOL: 1,
    SDValue.F64: 2,
    SDValue.I64: 3,
    SDValue.U64: 4,
    SDValue.NULL: 5,
}


class SegmentBuilder:
    """Single-segment bump allocator mirroring capnp's message builder."""

    def __init__(self):
        self.buf = bytearray(WORD)  # word 0: root pointer

    # -- low level ---------------------------------------------------------
    def alloc(self, nwords: int) -> int:
        at = len(self.buf) // WORD
        self.buf.extend(b"\x00" * (nwords * WORD))
        return at

    def _put_u64(self, word_idx: int, value: int):
        struct.pack_into("<Q", self.buf, word_idx * WORD, value)

    def put_struct_ptr(self, ptr_word: int, target_word: int, data_words: int, ptr_words: int):
        offset = target_word - ptr_word - 1
        lower = (offset << 2) & 0xFFFFFFFF
        upper = (data_words & 0xFFFF) | ((ptr_words & 0xFFFF) << 16)
        self._put_u64(ptr_word, lower | (upper << 32))

    def put_list_ptr(self, ptr_word: int, target_word: int, elem_size: int, count: int):
        offset = target_word - ptr_word - 1
        lower = ((offset << 2) | 1) & 0xFFFFFFFF
        upper = (elem_size & 7) | ((count & 0x1FFFFFFF) << 3)
        self._put_u64(ptr_word, lower | (upper << 32))

    # -- typed writes ------------------------------------------------------
    def set_data_u8(self, struct_word: int, byte_off: int, v: int):
        self.buf[struct_word * WORD + byte_off] = v & 0xFF

    def set_data_u16(self, struct_word: int, u16_index: int, v: int):
        struct.pack_into("<H", self.buf, struct_word * WORD + u16_index * 2, v & 0xFFFF)

    def set_data_f64(self, struct_word: int, word_off: int, v: float):
        struct.pack_into("<d", self.buf, (struct_word + word_off) * WORD, v)

    def set_data_i64(self, struct_word: int, word_off: int, v: int):
        struct.pack_into("<q", self.buf, (struct_word + word_off) * WORD, v)

    def set_data_u64(self, struct_word: int, word_off: int, v: int):
        struct.pack_into("<Q", self.buf, (struct_word + word_off) * WORD, v)

    def set_bool_bit(self, struct_word: int, bit: int, v: bool):
        if v:
            self.buf[struct_word * WORD + bit // 8] |= 1 << (bit % 8)

    def set_text(self, ptr_word: int, s: str):
        data = s.encode("utf-8") + b"\x00"
        nwords = (len(data) + WORD - 1) // WORD
        at = self.alloc(nwords)
        self.buf[at * WORD: at * WORD + len(data)] = data
        self.put_list_ptr(ptr_word, at, 2, len(data))

    def init_composite_list(self, ptr_word: int, count: int,
                            data_words: int, ptr_words: int) -> int:
        """Allocate tag word + elements; returns word index of element 0."""
        struct_words = data_words + ptr_words
        tag_at = self.alloc(1 + count * struct_words)
        # tag word: like a struct pointer whose offset field holds the count
        lower = (count << 2) & 0xFFFFFFFF
        upper = (data_words & 0xFFFF) | ((ptr_words & 0xFFFF) << 16)
        self._put_u64(tag_at, lower | (upper << 32))
        self.put_list_ptr(ptr_word, tag_at, 7, count * struct_words)
        return tag_at + 1

    def message_bytes(self) -> bytes:
        nwords = len(self.buf) // WORD
        return struct.pack("<II", 0, nwords) + bytes(self.buf)


def _write_pair(seg: SegmentBuilder, elem_word: int, key: str, value: SDValue):
    key_ptr = elem_word + PAIR_DATA_WORDS
    val_ptr = elem_word + PAIR_DATA_WORDS + 1
    seg.set_text(key_ptr, key)
    disc = _UNION_DISCRIMINANTS[value.kind]
    seg.set_data_u16(elem_word, 0, disc)
    if value.kind == SDValue.STRING:
        seg.set_text(val_ptr, value.value)
    elif value.kind == SDValue.BOOL:
        seg.set_bool_bit(elem_word, 16, value.value)
    elif value.kind == SDValue.F64:
        seg.set_data_f64(elem_word, 1, value.value)
    elif value.kind == SDValue.I64:
        seg.set_data_i64(elem_word, 1, value.value)
    elif value.kind == SDValue.U64:
        seg.set_data_u64(elem_word, 1, value.value)
    # NULL: discriminant only


def encode_record(record: Record, extra: List[Tuple[str, str]]) -> bytes:
    """Serialize a Record exactly as capnp_encoder.rs:45-106 does, in its
    allocation order (so the bytes match the reference's golden test)."""
    seg = SegmentBuilder()
    root = seg.alloc(RECORD_DATA_WORDS + RECORD_PTR_WORDS)
    seg.put_struct_ptr(0, root, RECORD_DATA_WORDS, RECORD_PTR_WORDS)
    ptrs = root + RECORD_DATA_WORDS

    seg.set_data_f64(root, 0, record.ts)
    seg.set_text(ptrs + _P_HOSTNAME, record.hostname)
    seg.set_data_u8(root, _FACILITY_OFF,
                    record.facility if record.facility is not None else FACILITY_MISSING)
    seg.set_data_u8(root, _SEVERITY_OFF,
                    record.severity if record.severity is not None else SEVERITY_MISSING)
    if record.appname is not None:
        seg.set_text(ptrs + _P_APPNAME, record.appname)
    if record.procid is not None:
        seg.set_text(ptrs + _P_PROCID, record.procid)
    if record.msgid is not None:
        seg.set_text(ptrs + _P_MSGID, record.msgid)
    if record.msg is not None:
        seg.set_text(ptrs + _P_MSG, record.msg)
    if record.full_msg is not None:
        seg.set_text(ptrs + _P_FULL_MSG, record.full_msg)
    if record.sd is not None:
        # only sd[0] fits the schema (capnp_encoder.rs:78-80)
        sd = record.sd[0]
        if sd.sd_id is not None:
            seg.set_text(ptrs + _P_SD_ID, sd.sd_id)
        elem0 = seg.init_composite_list(ptrs + _P_PAIRS, len(sd.pairs),
                                        PAIR_DATA_WORDS, PAIR_PTR_WORDS)
        for i, (name, value) in enumerate(sd.pairs):
            _write_pair(seg, elem0 + i * (PAIR_DATA_WORDS + PAIR_PTR_WORDS), name, value)
    if extra:
        elem0 = seg.init_composite_list(ptrs + _P_EXTRA, len(extra),
                                        PAIR_DATA_WORDS, PAIR_PTR_WORDS)
        for i, (name, value) in enumerate(extra):
            _write_pair(seg, elem0 + i * (PAIR_DATA_WORDS + PAIR_PTR_WORDS),
                        name, SDValue.string(value))
    return seg.message_bytes()


# ---------------------------------------------------------------------------
# Reader side (used by the capnp splitter)
# ---------------------------------------------------------------------------

class CapnpDecodeError(Exception):
    pass


class _SegmentReader:
    def __init__(self, segments: List[bytes]):
        self.segments = segments

    def word(self, seg: int, idx: int) -> int:
        data = self.segments[seg]
        off = idx * WORD
        if off + WORD > len(data):
            raise CapnpDecodeError("pointer out of bounds")
        return struct.unpack_from("<Q", data, off)[0]


def _read_text(rd: _SegmentReader, seg: int, ptr_word: int) -> Optional[str]:
    w = rd.word(seg, ptr_word)
    if w == 0:
        return None
    kind = w & 3
    if kind == 2:  # far pointer
        target_seg = (w >> 32) & 0xFFFFFFFF
        landing = (w >> 3) & 0x1FFFFFFF
        if w & 4:
            raise CapnpDecodeError("double-far pointers unsupported")
        return _read_text(rd, target_seg, landing)
    if kind != 1:
        raise CapnpDecodeError("expected list pointer for text")
    offset = _sign_extend_30((w & 0xFFFFFFFF) >> 2)
    count = (w >> 35) & 0x1FFFFFFF
    elem = (w >> 32) & 7
    if elem != 2 or count == 0:
        raise CapnpDecodeError("bad text pointer")
    start = (ptr_word + 1 + offset) * WORD
    data = rd.segments[seg][start:start + count]
    if len(data) != count or data[-1:] != b"\x00":
        raise CapnpDecodeError("bad text payload")
    return data[:-1].decode("utf-8", errors="strict")


def _sign_extend_30(v: int) -> int:
    return v - (1 << 30) if v & (1 << 29) else v


def _resolve_struct_ptr(rd: _SegmentReader, seg: int, ptr_word: int):
    w = rd.word(seg, ptr_word)
    if w == 0:
        return None
    kind = w & 3
    if kind == 2:
        target_seg = (w >> 32) & 0xFFFFFFFF
        landing = (w >> 3) & 0x1FFFFFFF
        if w & 4:
            raise CapnpDecodeError("double-far pointers unsupported")
        return _resolve_struct_ptr(rd, target_seg, landing)
    if kind != 0:
        raise CapnpDecodeError("expected struct pointer")
    offset = _sign_extend_30((w & 0xFFFFFFFF) >> 2)
    data_words = (w >> 32) & 0xFFFF
    ptr_words = (w >> 48) & 0xFFFF
    return seg, ptr_word + 1 + offset, data_words, ptr_words


def parse_message(data: bytes) -> "RecordReader":
    """Parse a framed capnp message into a RecordReader for the root Record."""
    if len(data) < 8:
        raise CapnpDecodeError("truncated segment table")
    nseg = struct.unpack_from("<I", data, 0)[0] + 1
    table_words = (1 + nseg + 1) // 2  # round up including the count slot
    sizes = struct.unpack_from(f"<{nseg}I", data, 4)
    off = table_words * WORD
    segments = []
    for sz in sizes:
        end = off + sz * WORD
        if end > len(data):
            raise CapnpDecodeError("truncated segment")
        segments.append(data[off:end])
        off = end
    rd = _SegmentReader(segments)
    resolved = _resolve_struct_ptr(rd, 0, 0)
    if resolved is None:
        raise CapnpDecodeError("null root")
    seg, struct_word, data_words, ptr_words = resolved
    return RecordReader(rd, seg, struct_word, data_words, ptr_words)


class RecordReader:
    """Typed accessor over a root Record struct (record_capnp.rs reader)."""

    def __init__(self, rd: _SegmentReader, seg: int, struct_word: int,
                 data_words: int, ptr_words: int):
        self.rd = rd
        self.seg = seg
        self.struct_word = struct_word
        self.data_words = data_words
        self.ptr_words = ptr_words

    def _data_bytes(self) -> bytes:
        start = self.struct_word * WORD
        return self.rd.segments[self.seg][start:start + self.data_words * WORD]

    def get_ts(self) -> float:
        d = self._data_bytes()
        if len(d) < 8:
            return 0.0
        return struct.unpack_from("<d", d, 0)[0]

    def _get_u8(self, off: int) -> int:
        d = self._data_bytes()
        return d[off] if off < len(d) else 0

    def get_facility(self) -> int:
        return self._get_u8(_FACILITY_OFF)

    def get_severity(self) -> int:
        return self._get_u8(_SEVERITY_OFF)

    def _text(self, slot: int) -> str:
        """capnp semantics: a null text pointer reads as the default "" —
        the reference's splitter golden test expects msgid Some("") for an
        unset field (capnp_splitter.rs:186)."""
        if slot >= self.ptr_words:
            return ""
        t = _read_text(self.rd, self.seg, self.struct_word + self.data_words + slot)
        return t if t is not None else ""

    def get_hostname(self):
        return self._text(_P_HOSTNAME)

    def get_appname(self):
        return self._text(_P_APPNAME)

    def get_procid(self):
        return self._text(_P_PROCID)

    def get_msgid(self):
        return self._text(_P_MSGID)

    def get_msg(self):
        return self._text(_P_MSG)

    def get_full_msg(self):
        return self._text(_P_FULL_MSG)

    def get_sd_id(self):
        return self._text(_P_SD_ID)

    def _pairs_from(self, slot: int) -> List[Tuple[str, SDValue]]:
        if slot >= self.ptr_words:
            return []
        ptr_word = self.struct_word + self.data_words + slot
        w = self.rd.word(self.seg, ptr_word)
        if w == 0:
            return []
        if (w & 3) != 1:
            raise CapnpDecodeError("expected list pointer for pairs")
        offset = _sign_extend_30((w & 0xFFFFFFFF) >> 2)
        elem = (w >> 32) & 7
        if elem != 7:
            raise CapnpDecodeError("expected composite list")
        tag_word = ptr_word + 1 + offset
        tag = self.rd.word(self.seg, tag_word)
        count = (tag & 0xFFFFFFFF) >> 2
        data_words = (tag >> 32) & 0xFFFF
        ptr_words = (tag >> 48) & 0xFFFF
        out = []
        stride = data_words + ptr_words
        for i in range(count):
            elem_word = tag_word + 1 + i * stride
            key = _read_text(self.rd, self.seg, elem_word + data_words) or ""
            ebytes = self.rd.segments[self.seg][elem_word * WORD:
                                                (elem_word + data_words) * WORD]
            disc = struct.unpack_from("<H", ebytes, 0)[0] if len(ebytes) >= 2 else 0
            if disc == 0:
                sval = SDValue.string(
                    _read_text(self.rd, self.seg, elem_word + data_words + 1) or "")
            elif disc == 1:
                sval = SDValue.bool_(bool(ebytes[2] & 1) if len(ebytes) > 2 else False)
            elif disc == 2:
                sval = SDValue.f64(struct.unpack_from("<d", ebytes, 8)[0])
            elif disc == 3:
                sval = SDValue.i64(struct.unpack_from("<q", ebytes, 8)[0])
            elif disc == 4:
                sval = SDValue.u64(struct.unpack_from("<Q", ebytes, 8)[0])
            elif disc == 5:
                sval = SDValue.null()
            else:
                raise CapnpDecodeError("unknown union discriminant")
            out.append((key, sval))
        return out

    def get_pairs(self):
        return self._pairs_from(_P_PAIRS)

    def get_extra(self):
        return self._pairs_from(_P_EXTRA)
