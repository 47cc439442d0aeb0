"""The hand-written CUDA kernels of the port, their loader, and the
chained framing→decode entries.

Kernels (sources in ``flowgger_tpu_torch/csrc``, one shared library each):

- ``frame_sep_spans`` — line/NUL record spans over a raw region
  (replaces ``pallas_kernels.frame_sep_spans_pallas``);
- ``frame_syslen_spans`` — octet-counted (syslen) frame spans over a raw
  region (replaces ``pallas_kernels.frame_syslen_spans_pallas``);
- ``frame_gather`` — the dense ``[rows, max_len]`` batch from the spans
  (replaces ``pallas_kernels.frame_gather_pallas``);
- ``decode_rfc5424`` — the per-row RFC5424 channels at 6 and 16 pairs
  (replaces ``rfc5424.decode_rfc5424_pallas``);
- ``structural_index`` — K5, the per-row JSON structural index
  (replaces ``pallas_kernels.structural_index_pallas``) in its two
  modes: nested containers (the JSON-lines decode, 8 and 24 fields) and
  flat objects, ``nested = 0`` (the GELF decode, 8, 16 and 24 fields);
- ``encode_gelf`` — the RFC5424→GELF encode of the device tier at 6 and
  16 pairs, a probe (each real row's tier bit before the width test and
  its length without the timestamp text) and an assemble (the tier rows'
  bytes at their offsets); it replaces the jnp
  ``device_gelf._encode_kernel`` with device_common's escape, sort,
  assembly and compaction stages, not a ``pallas_call``; beside it (the
  same source) E3, the RFC3164→GELF encode of the split rfc3164 tier, a
  probe and an assemble (replaces the jnp
  ``device_rfc3164._encode_kernel``); and EG, the GELF→GELF
  re-canonicalization of the split gelf tier at 8 and 16 fields
  (replaces the jnp ``device_gelf_gelf._encode_kernel``);
- ``decode_rfc3164`` — D3, the per-row RFC3164 channels (replaces the jnp
  ``rfc3164.decode_rfc3164``, not a ``pallas_call``);
- ``decode_ltsv`` — L1, the per-row LTSV channels of 24 parts (replaces
  the jnp ``ltsv.decode_ltsv``, not a ``pallas_call``); beside E1 and E3
  in ``encode_gelf``, EL, the LTSV→GELF encode of the split ltsv tier at
  6 and 16 pairs (replaces the jnp ``device_ltsv._encode_kernel``);
- ``fused_gelf`` — the fused routes F1 (rfc5424→GELF: K1's row decode and
  E1's probe in one kernel, then E1's assemble from the channels the
  probe carried), F3 (rfc3164→GELF: D3's and E3's), FL (ltsv→GELF:
  L1's and EL's) and FG (gelf→GELF: K5's flat row decode and EG's),
  replacing the jnp + Pallas ``fused_routes._fused_rfc5424_gelf`` and
  the jnp ``_fused_rfc3164_gelf``, ``_fused_ltsv_gelf`` and
  ``_fused_gelf_gelf``;
- ``classify_auto`` — AC, the auto-detect classifier: one class code a
  row of a mixed batch (replaces the jnp ``autodetect.classify_device``,
  not a ``pallas_call``), with the dns overlay of ``_extras_adjust`` as a
  flag (AC+dns);
- ``decode_dns`` — DN, the per-row DNS query-log channels (replaces the
  jnp ``dns.decode_dns``, not a ``pallas_call``);
- ``encode_ltsv_out`` — OL, the RFC5424→LTSV encode of the split tier
  for LTSV output, a probe and an assemble (replaces the jnp
  ``device_ltsv_out._encode_kernel``);
- ``fused_ltsv_out`` — FO/ltsv, the fused rfc5424→LTSV route: K1's row
  decode and OL's probe in one kernel, then OL's assemble from the
  carried channels (replaces the jnp + Pallas
  ``fused_routes._fused_rfc5424_ltsv``);
- ``encode_rfc5424_out`` — O5 and O5/3164, the RFC5424 and RFC3164 →
  RFC5424 encodes of the split tier for RFC5424 output, a probe and an
  assemble each (replace the jnp ``device_rfc5424_out._encode_kernel``
  and ``_encode_kernel_3164``);
- ``fused_rfc5424_out`` — FO/r5, the fused rfc5424→RFC5424 (K1 + O5)
  and rfc3164→RFC5424 (D3 + O5/3164) routes (replace the jnp + Pallas
  ``fused_routes._fused_rfc5424_rfc5424`` and the jnp
  ``_fused_rfc3164_rfc5424``);
- ``encode_capnp`` — OC, the rfc5424→Cap'n Proto encode of the split tier
  for capnp output at 6 and 16 pairs, a probe and an assemble (replaces
  the jnp ``device_capnp._encode_kernel``);
- ``fused_capnp_out`` — FO/capnp, the fused rfc5424→capnp route: K1's
  row decode and OC's probe in one kernel, then OC's assemble from the
  carried channels (replaces the jnp + Pallas
  ``fused_routes._fused_rfc5424_capnp``).

The one-warp-a-row kernels share their device code through headers in
``csrc`` (``warp_common.cuh``, ``decode_rfc5424_row.cuh``,
``decode_rfc3164_row.cuh``, ``encode_gelf_row.cuh``,
``structural_index_row.cuh``, ``encode_gelf_gelf_row.cuh``,
``encode_ltsv_out_row.cuh``, ``encode_rfc5424_out_row.cuh``,
``encode_capnp_row.cuh``, ...); each
``.cu`` still builds to one library.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, into ``build/cuda`` next to the
package (listed in ``.gitignore``), keyed by a hash of the source, the
headers and the flags so an edited source or header rebuilds.  :func:`build` compiles every
missing library in parallel — one ``nvcc`` per source, all started
together.  The libraries are loaded with ``ctypes``; a wrapper checks its
tensors, launches on PyTorch's current stream, raises on any CUDA error
the launch reports, and counts its launches in :data:`LAUNCHES`.
Nothing here falls back: no ``nvcc``, a failed build, or a refused launch
raises.  The plain PyTorch versions live beside the dispatchers that
choose between them by the tensor's device (``framing.sep_spans``,
``framing.syslen_spans``, ``framing.gather``,
``rfc5424.decode_rfc5424_submit``, ``rfc3164.decode_rfc3164_submit``,
``jsonl.decode_jsonl_submit``, ``ltsv.decode_ltsv_submit``,
``gelf.decode_on``, ``dns.decode_dns_submit``, ``device_gelf._Rows``,
``device_rfc3164._Rows``, ``device_ltsv._Rows``,
``device_gelf_gelf._Rows``, ``device_ltsv_out._Rows``,
``device_rfc5424_out._Rows``, ``device_capnp._Rows``,
``fused_routes._FusedRows`` and
``autodetect.classify_rows``).

``nvcc`` and the card are only touched inside the functions below,
never at import.
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
from typing import Dict, Iterable, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {
    "frame_sep_spans": "frame_sep_spans.cu",
    "frame_syslen_spans": "frame_syslen_spans.cu",
    "frame_gather": "frame_gather.cu",
    "decode_rfc5424": "decode_rfc5424.cu",
    "structural_index": "structural_index.cu",
    "encode_gelf": "encode_gelf.cu",
    "decode_rfc3164": "decode_rfc3164.cu",
    "fused_gelf": "fused_gelf.cu",
    "decode_ltsv": "decode_ltsv.cu",
    "classify_auto": "classify_auto.cu",
    "decode_dns": "decode_dns.cu",
    "encode_ltsv_out": "encode_ltsv_out.cu",
    "fused_ltsv_out": "fused_ltsv_out.cu",
    "encode_rfc5424_out": "encode_rfc5424_out.cu",
    "fused_rfc5424_out": "fused_rfc5424_out.cu",
    "encode_capnp": "encode_capnp.cu",
    "fused_capnp_out": "fused_capnp_out.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

# launches per kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel (the decode kernels count
# their instantiations apart: 6 and 16 pairs, 8, 16 and 24 fields; K5's
# flat mode, nested = 0, counts apart from its nested mode as "_flat",
# and AC with the dns overlay as "classify_auto_dns")
LAUNCHES: Dict[str, int] = {
    "frame_sep_spans": 0, "frame_syslen_spans": 0, "frame_gather": 0,
    "decode_rfc5424_p6": 0, "decode_rfc5424_p16": 0,
    "structural_index_f8": 0, "structural_index_f24": 0,
    "encode_gelf_probe_p6": 0, "encode_gelf_assemble_p6": 0,
    "encode_gelf_probe_p16": 0, "encode_gelf_assemble_p16": 0,
    "decode_rfc3164": 0,
    "encode_gelf3164_probe": 0, "encode_gelf3164_assemble": 0,
    "fused_rfc5424_gelf_probe": 0, "fused_rfc5424_gelf_assemble": 0,
    "fused_rfc3164_gelf_probe": 0, "fused_rfc3164_gelf_assemble": 0,
    "decode_ltsv": 0,
    "encode_gelf_ltsv_probe_p6": 0, "encode_gelf_ltsv_assemble_p6": 0,
    "encode_gelf_ltsv_probe_p16": 0, "encode_gelf_ltsv_assemble_p16": 0,
    "fused_ltsv_gelf_probe": 0, "fused_ltsv_gelf_assemble": 0,
    "structural_index_flat_f8": 0, "structural_index_flat_f16": 0,
    "structural_index_flat_f24": 0,
    "encode_gelf_gelf_probe_f8": 0, "encode_gelf_gelf_assemble_f8": 0,
    "encode_gelf_gelf_probe_f16": 0, "encode_gelf_gelf_assemble_f16": 0,
    "fused_gelf_gelf_probe": 0, "fused_gelf_gelf_assemble": 0,
    "classify_auto": 0, "classify_auto_dns": 0, "decode_dns": 0,
    "encode_ltsv_out_probe": 0, "encode_ltsv_out_assemble": 0,
    "fused_rfc5424_ltsv_probe": 0, "fused_rfc5424_ltsv_assemble": 0,
    "encode_rfc5424_out_probe": 0, "encode_rfc5424_out_assemble": 0,
    "encode_rfc3164_rfc5424_probe": 0, "encode_rfc3164_rfc5424_assemble": 0,
    "fused_rfc5424_rfc5424_probe": 0, "fused_rfc5424_rfc5424_assemble": 0,
    "fused_rfc3164_rfc5424_probe": 0, "fused_rfc3164_rfc5424_assemble": 0,
    "encode_capnp_probe_p6": 0, "encode_capnp_assemble_p6": 0,
    "encode_capnp_probe_p16": 0, "encode_capnp_assemble_p16": 0,
    "fused_rfc5424_capnp_probe": 0, "fused_rfc5424_capnp_assemble": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "frame_sep_spans": {
        "fg_frame_sep_spans": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    },
    "frame_syslen_spans": {
        "fg_frame_syslen_spans": (_P, _I, _I, _P, _P, _P, _P),
    },
    "frame_gather": {
        "fg_frame_gather": (_P, ctypes.c_longlong, _P, _P, _I, _I, _P, _P,
                            _P),
    },
    "decode_rfc5424": {
        "fg_decode_rfc5424_sd4_p6": (_P, _P, _P, _I, _I, _P),
        "fg_decode_rfc5424_sd4_p16": (_P, _P, _P, _I, _I, _P),
    },
    "structural_index": {
        f"fg_structural_index_f{f}": (_P, _P, _P, _I, _I, _I, _P)
        for f in (8, 16, 24)
    },
    "encode_gelf": {
        **{f"fg_encode_gelf_probe_p{p}": (_P, _P, _P, _P, _I, _I, _I, _I,
                                          _P, _P, _P) for p in (6, 16)},
        **{f"fg_encode_gelf_assemble_p{p}": (_P,) * 7 + (_I, _I, _I, _I,
                                                          _P, _P, _P)
           for p in (6, 16)},
        "fg_encode_gelf3164_probe": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
        "fg_encode_gelf3164_assemble": (_P,) * 7 + (_I, _I, _I, _I, _P, _P,
                                                    _P),
        **{f"fg_encode_gelf_ltsv_probe_p{p}": (_P, _P, _P, _P, _I, _I, _I,
                                               _P, _P, _P, _P)
           for p in (6, 16)},
        **{f"fg_encode_gelf_ltsv_assemble_p{p}": (_P,) * 7 + (_I, _I, _I, _I,
                                                              _P, _P, _P)
           for p in (6, 16)},
        **{f"fg_encode_gelf_gelf_probe_f{f}": (_P, _P, _P, _P, _I, _I, _I,
                                               _P, _P, _P, _P)
           for f in (8, 16)},
        **{f"fg_encode_gelf_gelf_assemble_f{f}": (_P,) * 7 + (_I, _I, _I, _I,
                                                              _P, _P, _P)
           for f in (8, 16)},
    },
    "decode_ltsv": {
        "fg_decode_ltsv": (_P, _P, _P, _I, _I, _I, _P),
    },
    "decode_rfc3164": {
        "fg_decode_rfc3164": (_P, _P, _I, _P, _I, _I, _P),
    },
    "classify_auto": {
        "fg_classify_auto": (_P, _P, _P, _I, _I, _I, _P),
    },
    "decode_dns": {
        "fg_decode_dns": (_P, _P, _P, _I, _I, _I, _P),
    },
    "encode_ltsv_out": {
        "fg_encode_ltsv_out_probe": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                     _P),
        "fg_encode_ltsv_out_assemble": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P, _P, _P),
    },
    "fused_ltsv_out": {
        "fg_fused_ltsv_out_carry": (_I,),
        "fg_fused_ltsv_out_probe": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                    _P, _P),
        "fg_fused_ltsv_out_assemble": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _P, _P, _P),
    },
    "encode_rfc5424_out": {
        "fg_encode_rfc5424_out_probe": (_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                        _P, _P),
        "fg_encode_rfc5424_out_assemble": (_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _P, _P, _P),
        "fg_encode_rfc3164_rfc5424_probe": (_P, _P, _P, _P, _I, _I, _I, _P,
                                            _P, _P, _P, _P),
        "fg_encode_rfc3164_rfc5424_assemble": (_P, _P, _P, _P, _P, _I, _I,
                                               _I, _I, _P, _P, _P),
    },
    "fused_rfc5424_out": {
        "fg_fused_rfc5424_out_carry": (_I,),
        "fg_fused_rfc5424_rfc5424_probe": (_P, _P, _P, _I, _I, _I, _P, _P,
                                           _P, _P, _P, _P),
        "fg_fused_rfc5424_rfc5424_assemble": (_P, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _P, _P, _P),
        "fg_fused_rfc3164_rfc5424_probe": (_P, _P, _I, _P, _I, _I, _I, _P,
                                           _P, _P, _P, _P, _P, _P),
        "fg_fused_rfc3164_rfc5424_assemble": (_P, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _P, _P, _P),
    },
    "encode_capnp": {
        **{f"fg_encode_capnp_probe_p{p}": (_P, _P, _P, _P, _I, _I, _I, _P,
                                           _P, _P, _P) for p in (6, 16)},
        **{f"fg_encode_capnp_assemble_p{p}": (_P, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _P, _P, _P)
           for p in (6, 16)},
    },
    "fused_capnp_out": {
        "fg_fused_capnp_out_carry": (),
        "fg_fused_rfc5424_capnp_probe": (_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                         _P, _P, _P),
        "fg_fused_rfc5424_capnp_assemble": (_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _P, _P, _P),
    },
    "fused_gelf": {
        "fg_fused_gelf_carry": (_I,),
        "fg_fused_rfc5424_gelf_probe": (_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                        _P, _P),
        "fg_fused_rfc5424_gelf_assemble": (_P,) * 7 + (_I, _I, _I, _I, _P,
                                                       _P, _P),
        "fg_fused_rfc3164_gelf_probe": (_P, _P, _I, _P, _I, _I, _I, _P, _P,
                                        _P, _P, _P),
        "fg_fused_rfc3164_gelf_assemble": (_P,) * 7 + (_I, _I, _I, _I, _P,
                                                       _P, _P),
        "fg_fused_ltsv_gelf_probe": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                     _P),
        "fg_fused_ltsv_gelf_assemble": (_P,) * 7 + (_I, _I, _I, _I, _P, _P,
                                                    _P),
        "fg_fused_gelf_gelf_probe": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                     _P),
        "fg_fused_gelf_gelf_assemble": (_P,) * 7 + (_I, _I, _I, _I, _P, _P,
                                                    _P),
    },
}
_TILE_BYTES = 16384  # kTile in frame_sep_spans.cu
# decode_rfc5424.cu, decode_rfc3164.cu, decode_ltsv.cu and
# structural_index.cu stage kWarps rows, each padded to 16 bytes
# (decode_rfc5424.cu also its class masks past each row:
# _rfc5424_stage_bytes), in dynamic shared memory beside their static
# per-warp sums and channel tile (< 8 KiB and < 12 KiB), within the
# 227 KiB a block may use
_DECODE_ROWS_PER_BLOCK = 8
_DECODE_STAGING_BYTES = 219 * 1024
_INDEX_STAGING_BYTES = 215 * 1024
# int32 entries a row of the fused routes' carried channel tensor: the
# channels fused_routes.DEMAND names (F1: 18 row channels, 2 x 4 SD
# spans, 5 x 6 pair channels; F3: 11); fused_gelf.cu kCarry5 / kCarry3;
# FL: EL's selection after the sort (7 row values, 4 x 6 pair spans;
# encode_ltsv_row.cuh kCarryL, fused_routes.carried_columns); FG: EG's
# selection after special routing and the sort (9 row values, 5 x 8 pair
# values; encode_gelf_gelf_row.cuh kCarryG)
FUSED_CARRY = {"rfc5424": 56, "rfc3164": 11, "ltsv": 31, "gelf": 49}
# FO/ltsv: the channels OL's assemble reads (14 row channels, 4 x 6 pair
# spans; fused_ltsv_out.cu kCarryO, fused_routes._LTSV_OUT_CARRY)
FUSED_LTSV_OUT_CARRY = 38
# FO/r5: the channels the assembles of O5 (12 row channels, 2 x 4 SD
# spans, 5 x 6 pair channels) and O5/3164 (3) read; fused_rfc5424_out.cu
# kCarryR5 / kCarryR3, fused_routes._OUT_CARRY
FUSED_R5_OUT_CARRY = {"rfc5424": 50, "rfc3164": 3}
# FO/capnp: the channels OC's assemble reads (13 row channels, sd[0]'s id
# span, 5 x 6 pair channels); fused_capnp_out.cu kCarryC,
# fused_routes._OUT_CARRY
FUSED_CAPNP_CARRY = 45



def _rfc5424_stage_bytes(L: int) -> int:
    """Shared bytes a warp of decode_rfc5424.cu takes: the staged row and
    ten mask words a 32-position word plus eight ints
    (decode_rfc5424_row.cuh stage_bytes)."""
    def r16(v):
        return -(-v // 16) * 16
    return r16(L) + r16(4 * (10 * -(-L // 32) + 8))

_libs: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()
# frame_sep_spans' look-back scratch per (device, stream): int64 word 0
# holds its two uint32 counters, words 1.. one status word a tile.  It is
# zeroed once, at allocation, and every launch leaves it zero again.
_sep_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launched(name: str) -> None:
    # lanes launch from several threads at once: one lock keeps the
    # counts whole
    with _count_lock:
        LAUNCHES[name] += 1


def build_dir() -> Path:
    return _CSRC.parent.parent / "build" / "cuda"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of flowgger_tpu_torch "
                       "are built from source at first use and need the CUDA "
                       "toolkit")


def _lib_path(name: str) -> Path:
    # the source and every shared header under csrc/ key the build
    src = (_CSRC / _SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing kernel library, one ``nvcc`` per source,
    all started together.  Returns ``{name: {"seconds", "log",
    "cached"}}``, where ``log`` is nvcc's output (kept beside the library,
    so a cached build returns it too); raises RuntimeError naming the
    source if any build fails."""
    names = list(names or _SOURCES)
    out: Dict[str, dict] = {}
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    for name in names:
        dst = _lib_path(name)
        if dst.exists() and dst.with_suffix(".log").exists():
            out[name] = {"seconds": 0.0, "cached": True,
                         "log": dst.with_suffix(".log").read_text()}
            continue
        tmp = dst.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / _SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, dst)
    failed = []
    for name, (proc, t0, tmp, dst) in procs.items():
        log = proc.communicate()[0].decode("utf-8", "replace")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{_SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        dst.with_suffix(".log").write_text(log)
        os.replace(tmp, dst)
        out[name] = {"seconds": secs, "log": log, "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    # builds publish atomically (os.replace), so two callers racing here
    # at first use at worst both compile; the load itself is locked
    build([name])
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, args in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(args)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _stream() -> int:
    # the calling thread's current stream: a lane's ingest and fetcher
    # threads each enter the lane's stream (overlap.Lane.scope)
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {rc})")


def _need(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor (got {t.dtype}, shape {tuple(t.shape)})")


# ---------------------------------------------------------------------------
# wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def frame_sep_spans_cuda(region: torch.Tensor, rlen: int, sep: int = 10,
                         strip_cr: bool = True, ncap: int = 256):
    """Record spans over ``region[:rlen]`` (u8 [B] on a CUDA device):
    ``{"starts", "lens"}`` int32 [ncap] and ``"meta"`` int32 [4] =
    (n, consumed, overflow, 0), all on the device.

    One launch: a single-pass scan whose blocks pass their prefixes on
    through look-back status words.  Those live in a scratch kept per
    device and stream (zeroed once, when it is allocated or grown, and
    left zero by every launch), so a call launches nothing else."""
    _need(region, "region", torch.uint8, 1)
    # the status words hold counts and positions in 31 bits
    if not 0 <= rlen <= min(region.shape[0], (1 << 31) - 1) or ncap < 1:
        raise ValueError(f"bad span geometry rlen={rlen} B={region.shape[0]} "
                         f"ncap={ncap}")
    dev = region.device
    ntiles = max(1, -(-rlen // _TILE_BYTES))
    stream = _stream()
    key = (dev.index, stream)
    scratch = _sep_scratch.get(key)
    if scratch is None or scratch.numel() - 1 < ntiles:
        cap = 1024
        while cap < ntiles:
            cap <<= 1
        scratch = torch.zeros(1 + cap, dtype=torch.int64, device=dev)
        _sep_scratch[key] = scratch
    starts = torch.empty(ncap, dtype=torch.int32, device=dev)
    lens = torch.empty(ncap, dtype=torch.int32, device=dev)
    meta = torch.empty(4, dtype=torch.int32, device=dev)
    rc = _lib("frame_sep_spans").fg_frame_sep_spans(
        region.data_ptr(), rlen, sep, int(bool(strip_cr)), ncap,
        scratch.data_ptr(), scratch[1:].data_ptr(), starts.data_ptr(),
        lens.data_ptr(), meta.data_ptr(), stream)
    _check(rc, "frame_sep_spans")
    _launched("frame_sep_spans")
    return {"starts": starts, "lens": lens, "meta": meta}


def frame_syslen_spans_cuda(region: torch.Tensor, rlen: int,
                            ncap: int = 256):
    """Octet-count frame spans over ``region[:rlen]`` (u8 [B] on a CUDA
    device): ``{"starts", "lens"}`` int32 [ncap] and ``"meta"`` int32
    [4] = (n, consumed, err, decline), all on the device."""
    _need(region, "region", torch.uint8, 1)
    if not 0 <= rlen <= region.shape[0] or ncap < 1:
        raise ValueError(f"bad span geometry rlen={rlen} B={region.shape[0]} "
                         f"ncap={ncap}")
    dev = region.device
    starts = torch.empty(ncap, dtype=torch.int32, device=dev)
    lens = torch.empty(ncap, dtype=torch.int32, device=dev)
    meta = torch.empty(4, dtype=torch.int32, device=dev)
    rc = _lib("frame_syslen_spans").fg_frame_syslen_spans(
        region.data_ptr(), rlen, ncap, starts.data_ptr(), lens.data_ptr(),
        meta.data_ptr(), _stream())
    _check(rc, "frame_syslen_spans")
    _launched("frame_syslen_spans")
    return {"starts": starts, "lens": lens, "meta": meta}


def frame_gather_cuda(region: torch.Tensor, starts: torch.Tensor,
                      lens: torch.Tensor, max_len: int = 512):
    """``(batch u8 [rows, max_len], lens_c int32 [rows])`` on the
    device: each row holds ``region[starts[r]:][:min(lens[r], max_len)]``
    and zeros after it."""
    _need(region, "region", torch.uint8, 1)
    _need(starts, "starts", torch.int32, 1)
    _need(lens, "lens", torch.int32, 1)
    rows = starts.shape[0]
    if lens.shape[0] != rows or max_len < 1:
        raise ValueError("starts/lens must have one entry per row")
    out = torch.empty((rows, max_len), dtype=torch.uint8, device=region.device)
    lens_c = torch.empty(rows, dtype=torch.int32, device=region.device)
    rc = _lib("frame_gather").fg_frame_gather(
        region.data_ptr(), region.shape[0], starts.data_ptr(),
        lens.data_ptr(), rows, max_len, out.data_ptr(), lens_c.data_ptr(),
        _stream())
    _check(rc, "frame_gather")
    _launched("frame_gather")
    return out, lens_c


def decode_rfc5424_cuda(batch: torch.Tensor, lens: torch.Tensor,
                        max_sd: int = 4, max_pairs: int = 6) -> torch.Tensor:
    """The RFC5424 channels of ``batch`` (u8 [N, L]) as one int32
    ``[C, N]`` tensor on the device (``rfc5424.unpack_channels`` splits
    it).  Instantiated for max_sd = 4 with 6 or 16 pairs."""
    from .rfc5424 import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] != N or L < 4:
        raise ValueError("lens must have one entry per row and rows at "
                         "least 4 bytes")
    if max_sd != 4 or max_pairs not in (6, 16):
        raise ValueError(f"no decode_rfc5424 kernel for max_sd={max_sd} "
                         f"max_pairs={max_pairs}")
    if _DECODE_ROWS_PER_BLOCK * _rfc5424_stage_bytes(L) > _DECODE_STAGING_BYTES:
        raise ValueError(f"rows of {L} bytes exceed the decode kernel's "
                         "shared-memory staging")
    out = torch.empty((n_channels(max_sd, max_pairs), N), dtype=torch.int32,
                      device=batch.device)
    fn = getattr(_lib("decode_rfc5424"), f"fg_decode_rfc5424_sd4_p{max_pairs}")
    rc = fn(batch.data_ptr(), lens.data_ptr(), out.data_ptr(), N, L, _stream())
    _check(rc, "decode_rfc5424")
    _launched(f"decode_rfc5424_p{max_pairs}")
    return out


def structural_index_cuda(batch: torch.Tensor, lens: torch.Tensor,
                          max_fields: int = 8, nested: int = 4
                          ) -> torch.Tensor:
    """K5: the JSON structural index of ``batch`` (u8 [N, L]) as one
    int32 ``[2 + 7 * max_fields, N]`` tensor on the device
    (``jsonidx.unpack_channels`` splits it).  Two modes:
    ``nested`` >= 1 admits containers that many levels below the top
    object (the JSON-lines decode; 8 and 24 fields), ``nested = 0`` is
    the flat mode (the GELF decode; 8, 16 and 24 fields), where any
    bracket outside a string flags the row."""
    from .jsonidx import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] != N or L < 1:
        raise ValueError("lens must have one entry per row")
    if nested < 0 or max_fields not in ((8, 16, 24) if nested == 0
                                        else (8, 24)):
        raise ValueError(f"no structural_index kernel for max_fields="
                         f"{max_fields} nested={nested}: the nested mode "
                         "(nested >= 1) has 8 and 24 fields, the flat mode "
                         "(nested = 0) 8, 16 and 24")
    if _DECODE_ROWS_PER_BLOCK * 16 * (-(-L // 16)) > _INDEX_STAGING_BYTES:
        raise ValueError(f"rows of {L} bytes exceed the structural index "
                         "kernel's shared-memory staging")
    out = torch.empty((n_channels(max_fields), N), dtype=torch.int32,
                      device=batch.device)
    fn = getattr(_lib("structural_index"), f"fg_structural_index_f{max_fields}")
    rc = fn(batch.data_ptr(), lens.data_ptr(), out.data_ptr(), N, L, nested,
            _stream())
    _check(rc, "structural_index")
    _launched(f"structural_index{'_flat' if nested == 0 else ''}"
              f"_f{max_fields}")
    return out


def encode_gelf_cuda(batch: torch.Tensor, lens: torch.Tensor,
                     channels: torch.Tensor, n: int, bank: torch.Tensor,
                     consts, max_sd: int, max_pairs: int, OW: int = 0,
                     ts_text: Optional[torch.Tensor] = None,
                     ts_len: Optional[torch.Tensor] = None,
                     row_off: Optional[torch.Tensor] = None,
                     total: int = 0):
    """The device GELF encode of the first ``n`` rows of ``batch`` (u8
    [N, L]) from the decode kernel's packed ``channels`` (int32 [C, N] at
    ``max_sd`` = 4 and ``max_pairs`` = 6 or 16) and the constant bank
    (u8 on the device; ``consts`` is the host table of
    ``device_gelf.kernel_consts``).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32
    [N])``, the tier bit before the width test and the length without
    the timestamp text, 0 for rows outside it and rows at or past ``n``.
    With ``row_off`` (int64 [N]), ``ts_text`` (u8 [N, 32]), ``ts_len``
    (int32 [N]) and the output width ``OW`` it assembles: a u8 [total]
    buffer holding the elided bytes of each row whose offset is not
    negative, at that offset."""
    from .rfc5424 import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if max_pairs not in (6, 16):
        raise ValueError(f"no encode_gelf kernel for max_pairs={max_pairs}")
    if channels.shape != (n_channels(4, max_pairs), N) or lens.shape[0] != N:
        raise ValueError("channels must be the [C, N] decode output at "
                         "max_sd=4 and lens one entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_gelf")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        rc = getattr(lib, f"fg_encode_gelf_probe_p{max_pairs}")(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, max_sd, tier.data_ptr(), base_len.data_ptr(), _stream())
        _check(rc, "encode_gelf probe")
        _launched(f"encode_gelf_probe_p{max_pairs}")
        return tier, base_len
    _assemble_args(N, OW, ts_text, ts_len, row_off)
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = getattr(lib, f"fg_encode_gelf_assemble_p{max_pairs}")(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        ts_text.data_ptr(), ts_len.data_ptr(), bank.data_ptr(), consts, N, n,
        L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "encode_gelf assemble")
    _launched(f"encode_gelf_assemble_p{max_pairs}")
    return flat


def decode_rfc3164_cuda(batch: torch.Tensor, lens: torch.Tensor,
                        year: int) -> torch.Tensor:
    """The RFC3164 channels of ``batch`` (u8 [N, L]) for ``year`` as one
    int32 ``[12, N]`` tensor on the device (``rfc3164.unpack_channels``
    splits it)."""
    from .rfc3164 import KEYS

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] != N or L < 1:
        raise ValueError("lens must have one entry per row")
    if _DECODE_ROWS_PER_BLOCK * 16 * (-(-L // 16)) > _DECODE_STAGING_BYTES:
        raise ValueError(f"rows of {L} bytes exceed the decode kernel's "
                         "shared-memory staging")
    out = torch.empty((len(KEYS), N), dtype=torch.int32, device=batch.device)
    rc = _lib("decode_rfc3164").fg_decode_rfc3164(
        batch.data_ptr(), lens.data_ptr(), int(year), out.data_ptr(), N, L,
        _stream())
    _check(rc, "decode_rfc3164")
    _launched("decode_rfc3164")
    return out


def decode_ltsv_cuda(batch: torch.Tensor, lens: torch.Tensor,
                     n: int) -> torch.Tensor:
    """L1: the LTSV channels of ``batch`` (u8 [N, L]) as one int32
    ``[94, N]`` tensor on the device (``ltsv.unpack_channels`` splits
    it); rows at and past ``n`` are padding (an empty row's channels,
    their bytes never read)."""
    from .ltsv import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] != N or not 1 <= L < 1 << 15 or not 0 <= n <= N:
        raise ValueError(f"bad ltsv decode geometry L={L} n={n} N={N}")
    if _DECODE_ROWS_PER_BLOCK * 16 * (-(-L // 16)) > _DECODE_STAGING_BYTES:
        raise ValueError(f"rows of {L} bytes exceed the decode kernel's "
                         "shared-memory staging")
    out = torch.empty((n_channels(), N), dtype=torch.int32,
                      device=batch.device)
    rc = _lib("decode_ltsv").fg_decode_ltsv(
        batch.data_ptr(), lens.data_ptr(), out.data_ptr(), N, n, L, _stream())
    _check(rc, "decode_ltsv")
    _launched("decode_ltsv")
    return out


def classify_auto_cuda(batch: torch.Tensor, lens: torch.Tensor,
                       n: int, dns: bool = False) -> torch.Tensor:
    """AC: the auto-detect class code of each of the first ``n`` rows of
    ``batch`` (u8 [N, L]), int8 [n] on the device
    (``autodetect.classify_plain`` is its plain version); ``dns`` adds the
    dns overlay (counted as ``classify_auto_dns``)."""
    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] < n or not 0 <= n <= N or L < 1:
        raise ValueError(f"bad classify geometry L={L} n={n} N={N} "
                         f"lens={lens.shape[0]}")
    out = torch.empty(n, dtype=torch.int8, device=batch.device)
    rc = _lib("classify_auto").fg_classify_auto(
        batch.data_ptr(), lens.data_ptr(), out.data_ptr(), n, L, int(dns),
        _stream())
    _check(rc, "classify_auto")
    _launched("classify_auto_dns" if dns else "classify_auto")
    return out


def decode_dns_cuda(batch: torch.Tensor, lens: torch.Tensor,
                    n: int) -> torch.Tensor:
    """DN: the DNS query-log channels of ``batch`` (u8 [N, L]) as one int32
    ``[14, N]`` tensor on the device (``dns.unpack_channels`` splits it);
    rows at and past ``n`` are padding (an empty row's channels, their
    bytes never read)."""
    from .dns import KEYS

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    N, L = batch.shape
    if lens.shape[0] != N or not 1 <= L < 1 << 15 or not 0 <= n <= N:
        raise ValueError(f"bad dns decode geometry L={L} n={n} N={N}")
    out = torch.empty((len(KEYS), N), dtype=torch.int32, device=batch.device)
    rc = _lib("decode_dns").fg_decode_dns(
        batch.data_ptr(), lens.data_ptr(), out.data_ptr(), N, n, L, _stream())
    _check(rc, "decode_dns")
    _launched("decode_dns")
    return out


def encode_ltsv_out_cuda(batch: torch.Tensor, lens: torch.Tensor,
                         channels: torch.Tensor, n: int, bank: torch.Tensor,
                         consts, OW: int = 0,
                         row_off: Optional[torch.Tensor] = None,
                         total: int = 0):
    """OL, the device LTSV encode of the first ``n`` rows of an rfc5424
    ``batch`` (u8 [N, L]) from K1's packed ``channels`` (int32 [C, N] at 4
    SD elements and 6 pairs) and the constant bank (``consts``:
    ``device_ltsv_out.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    gaps int32 [2, N])``, the tier bit before the width test, the elided
    length (no timestamp text in it) and the gap0 / gap1 splice offsets,
    0 for rows outside the tier and rows at or past ``n``.  With
    ``row_off`` (int64 [N]) and the output width ``OW`` it assembles: a
    u8 [total] buffer holding the elided bytes of each row whose offset
    is not negative, at that offset."""
    from .rfc5424 import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if channels.shape != (n_channels(4, 6), N) or lens.shape[0] != N:
        raise ValueError("channels must be the [C, N] decode output at "
                         "max_sd=4 and 6 pairs, lens one entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_ltsv_out")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        gaps = torch.empty((2, N), dtype=torch.int32, device=dev)
        rc = lib.fg_encode_ltsv_out_probe(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, tier.data_ptr(), base_len.data_ptr(), gaps.data_ptr(),
            _stream())
        _check(rc, "encode_ltsv_out probe")
        _launched("encode_ltsv_out_probe")
        return tier, base_len, gaps
    _need(row_off, "row_off", torch.int64, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = lib.fg_encode_ltsv_out_assemble(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        bank.data_ptr(), consts, N, n, L, OW, row_off.data_ptr(),
        flat.data_ptr(), _stream())
    _check(rc, "encode_ltsv_out assemble")
    _launched("encode_ltsv_out_assemble")
    return flat


def fused_ltsv_out_cuda(batch: torch.Tensor, lens: torch.Tensor, n: int,
                        bank: torch.Tensor, consts, OW: int = 0,
                        row_off: Optional[torch.Tensor] = None,
                        total: int = 0, chan: Optional[torch.Tensor] = None,
                        tier: Optional[torch.Tensor] = None):
    """FO/ltsv, the fused rfc5424→LTSV route on the first ``n`` rows of
    ``batch`` (u8 [N, L]): K1's decode at 6 pairs, then OL (``consts``:
    ``device_ltsv_out.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small int32 [5, N], chan int32 [N, 38], gaps int32 [2, N])``, OL's
    probe outputs, the ok, days, sod, off and nanos channels (zeros at and
    past ``n``) and the carried channels: row r of ``chan`` holds the
    :data:`FUSED_LTSV_OUT_CARRY` channels OL's assemble reads where
    ``base[r]`` is set, and is not written elsewhere.  With ``row_off``,
    ``OW`` and the probe's ``chan`` and ``base`` (as ``tier``) it
    assembles from the carried channels, as :func:`fused_gelf_cuda`
    does: no decode runs again; it raises ValueError, before any launch,
    if a row it writes is not a probe tier row, or without ``chan`` or
    ``tier``."""
    assembling = row_off is not None
    if assembling and (chan is None or tier is None):
        raise ValueError("a fused assemble needs the probe's carried channels "
                         "(chan) and tier bits (tier): it does not decode "
                         "again")
    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if lens.shape[0] != N or not 4 <= L < 1 << 15:
        raise ValueError(f"bad fused geometry L={L} N={N}")
    if not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad fused geometry n={n} N={N}")
    C = FUSED_LTSV_OUT_CARRY
    dev = batch.device
    name = "fused_rfc5424_ltsv"
    if not assembling:
        base = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        gaps = torch.empty((2, N), dtype=torch.int32, device=dev)
        small = torch.empty((5, N), dtype=torch.int32, device=dev)
        carried = torch.empty((N, C), dtype=torch.int32, device=dev)
        rc = _lib("fused_ltsv_out").fg_fused_ltsv_out_probe(
            batch.data_ptr(), lens.data_ptr(), consts, N, n, L,
            base.data_ptr(), base_len.data_ptr(), gaps.data_ptr(),
            small.data_ptr(), carried.data_ptr(), _stream())
        _check(rc, f"{name} probe")
        _launched(f"{name}_probe")
        return base, base_len, small, carried, gaps
    _need(row_off, "row_off", torch.int64, 1)
    _need(chan, "chan", torch.int32, 2)
    _need(tier, "tier", torch.bool, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    if chan.shape != (N, C) or tier.shape[0] != N:
        raise ValueError(f"chan must be the probe's [N, {C}] carried channels "
                         "and tier its [N] tier bits")
    # the carried channels exist only for the probe's tier rows
    if bool(((row_off >= 0) & ~tier).any()):
        raise ValueError(f"{name} assemble: row_off keeps a row outside the "
                         "probe's tier")
    return fused_ltsv_out_assemble_launch(batch, lens, n, bank, consts, OW,
                                          row_off, total, chan)


def fused_ltsv_out_assemble_launch(batch, lens, n: int, bank, consts,
                                   OW: int, row_off, total: int,
                                   chan) -> torch.Tensor:
    """The launch behind :func:`fused_ltsv_out_cuda`'s assemble, after
    its checks (no host synchronization, so a device timing loop can
    issue it back to back); returns the u8 [total] buffer."""
    N, L = batch.shape
    flat = torch.empty(total, dtype=torch.uint8, device=batch.device)
    if total == 0:
        return flat
    rc = _lib("fused_ltsv_out").fg_fused_ltsv_out_assemble(
        batch.data_ptr(), lens.data_ptr(), chan.data_ptr(), bank.data_ptr(),
        consts, N, n, L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "fused_rfc5424_ltsv assemble")
    _launched("fused_rfc5424_ltsv_assemble")
    return flat


def encode_rfc5424_out_cuda(leg: str, batch: torch.Tensor,
                            lens: torch.Tensor, channels: torch.Tensor,
                            n: int, bank: torch.Tensor, consts, OW: int = 0,
                            row_off: Optional[torch.Tensor] = None,
                            total: int = 0):
    """O5 (``leg = "rfc5424"``, ``channels`` K1's packed int32 [C, N] at
    4 SD blocks and 6 pairs) or O5/3164 (``leg = "rfc3164"``, D3's packed
    int32 [12, N]), the device RFC5424 encode of the first ``n`` rows of
    ``batch`` (u8 [N, L]) with the constant bank (``consts``:
    ``device_rfc5424_out.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small8 u8 [2, N])`` for O5 (fac8, sev8) and ``(base, base_len, small8
    u8 [3, N], hostl16 uint16 [N])`` for O5/3164 (fac8, sev8, pri1 and the
    host length): the tier bit before the width test and the elided
    length, 0 for rows outside the tier, every output 0 for rows at or
    past ``n``.  With ``row_off`` (int64 [N]) and the output width ``OW``
    it assembles: a u8 [total] buffer holding the elided bytes of each
    row whose offset is not negative, at that offset."""
    from .rfc3164 import KEYS
    from .rfc5424 import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    r3 = leg == "rfc3164"
    C = len(KEYS) if r3 else n_channels(4, 6)
    if leg not in ("rfc5424", "rfc3164"):
        raise ValueError(f"no O5 leg {leg!r}")
    if channels.shape != (C, N) or lens.shape[0] != N:
        raise ValueError(f"channels must be the [{C}, N] {leg} decode "
                         "output, lens one entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_rfc5424_out")
    name = "encode_rfc3164_rfc5424" if r3 else "encode_rfc5424_out"
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small8 = torch.empty((3 if r3 else 2, N), dtype=torch.uint8,
                             device=dev)
        if r3:
            hostl16 = torch.empty(N, dtype=torch.uint16, device=dev)
            rc = lib.fg_encode_rfc3164_rfc5424_probe(
                batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
                consts, N, n, L, tier.data_ptr(), base_len.data_ptr(),
                small8.data_ptr(), hostl16.data_ptr(), _stream())
        else:
            rc = lib.fg_encode_rfc5424_out_probe(
                batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
                consts, N, n, L, tier.data_ptr(), base_len.data_ptr(),
                small8.data_ptr(), _stream())
        _check(rc, f"{name} probe")
        _launched(f"{name}_probe")
        return (tier, base_len, small8, hostl16) if r3 else \
            (tier, base_len, small8)
    _need(row_off, "row_off", torch.int64, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    fn = lib.fg_encode_rfc3164_rfc5424_assemble if r3 else \
        lib.fg_encode_rfc5424_out_assemble
    rc = fn(batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
            bank.data_ptr(), consts, N, n, L, OW, row_off.data_ptr(),
            flat.data_ptr(), _stream())
    _check(rc, f"{name} assemble")
    _launched(f"{name}_assemble")
    return flat


def fused_rfc5424_out_cuda(fmt: str, batch: torch.Tensor, lens: torch.Tensor,
                           n: int, bank: torch.Tensor, consts, year: int = 0,
                           OW: int = 0, row_off: Optional[torch.Tensor] = None,
                           total: int = 0,
                           chan: Optional[torch.Tensor] = None,
                           tier: Optional[torch.Tensor] = None):
    """FO/r5, the fused ``fmt`` (rfc5424 or rfc3164) → RFC5424 route on
    the first ``n`` rows of ``batch`` (u8 [N, L]): K1's decode at 4 SD
    blocks and 6 pairs then O5, or D3's decode for ``year`` then O5/3164
    (``consts``: ``device_rfc5424_out.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small int32 [5, N], chan int32 [N, C], small8 u8 [2|3, N], hostl16
    uint16 [N] or None)``: the split tier's probe outputs, the ok, days,
    sod, off and nanos channels (zeros at and past ``n``) and the carried
    channels: row r of ``chan`` holds the :data:`FUSED_R5_OUT_CARRY`
    channels the leg's assemble reads where ``base[r]`` is set, and is not
    written elsewhere.  With ``row_off``, ``OW`` and the probe's ``chan``
    and ``base`` (as ``tier``) it assembles from the carried channels, as
    :func:`fused_gelf_cuda` does: no decode runs again; it raises
    ValueError, before any launch, if a row it writes is not a probe tier
    row, or without ``chan`` or ``tier``."""
    assembling = row_off is not None
    if fmt not in FUSED_R5_OUT_CARRY:
        raise ValueError(f"no fused {fmt} → RFC5424 route")
    if assembling and (chan is None or tier is None):
        raise ValueError("a fused assemble needs the probe's carried channels "
                         "(chan) and tier bits (tier): it does not decode "
                         "again")
    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if lens.shape[0] != N or not 4 <= L < 1 << 15:
        raise ValueError(f"bad fused geometry L={L} N={N}")
    if not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad fused geometry n={n} N={N}")
    r3 = fmt == "rfc3164"
    C = FUSED_R5_OUT_CARRY[fmt]
    dev = batch.device
    name = f"fused_{fmt}_rfc5424"
    lib = _lib("fused_rfc5424_out")
    if not assembling:
        base = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small = torch.empty((5, N), dtype=torch.int32, device=dev)
        small8 = torch.empty((3 if r3 else 2, N), dtype=torch.uint8,
                             device=dev)
        carried = torch.empty((N, C), dtype=torch.int32, device=dev)
        hostl16 = None
        if r3:
            hostl16 = torch.empty(N, dtype=torch.uint16, device=dev)
            rc = lib.fg_fused_rfc3164_rfc5424_probe(
                batch.data_ptr(), lens.data_ptr(), int(year), consts, N, n,
                L, base.data_ptr(), base_len.data_ptr(), small.data_ptr(),
                small8.data_ptr(), hostl16.data_ptr(), carried.data_ptr(),
                _stream())
        else:
            rc = lib.fg_fused_rfc5424_rfc5424_probe(
                batch.data_ptr(), lens.data_ptr(), consts, N, n, L,
                base.data_ptr(), base_len.data_ptr(), small.data_ptr(),
                small8.data_ptr(), carried.data_ptr(), _stream())
        _check(rc, f"{name} probe")
        _launched(f"{name}_probe")
        return base, base_len, small, carried, small8, hostl16
    _need(row_off, "row_off", torch.int64, 1)
    _need(chan, "chan", torch.int32, 2)
    _need(tier, "tier", torch.bool, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    if chan.shape != (N, C) or tier.shape[0] != N:
        raise ValueError(f"chan must be the probe's [N, {C}] carried channels "
                         "and tier its [N] tier bits")
    # the carried channels exist only for the probe's tier rows
    if bool(((row_off >= 0) & ~tier).any()):
        raise ValueError(f"{name} assemble: row_off keeps a row outside the "
                         "probe's tier")
    return fused_rfc5424_out_assemble_launch(fmt, batch, lens, n, bank,
                                             consts, OW, row_off, total,
                                             chan)


def fused_rfc5424_out_assemble_launch(fmt: str, batch, lens, n: int, bank,
                                      consts, OW: int, row_off, total: int,
                                      chan) -> torch.Tensor:
    """The launch behind :func:`fused_rfc5424_out_cuda`'s assemble, after
    its checks (no host synchronization, so a device timing loop can
    issue it back to back); returns the u8 [total] buffer."""
    N, L = batch.shape
    flat = torch.empty(total, dtype=torch.uint8, device=batch.device)
    if total == 0:
        return flat
    lib = _lib("fused_rfc5424_out")
    fn = lib.fg_fused_rfc3164_rfc5424_assemble if fmt == "rfc3164" else \
        lib.fg_fused_rfc5424_rfc5424_assemble
    rc = fn(batch.data_ptr(), lens.data_ptr(), chan.data_ptr(),
            bank.data_ptr(), consts, N, n, L, OW, row_off.data_ptr(),
            flat.data_ptr(), _stream())
    _check(rc, f"fused_{fmt}_rfc5424 assemble")
    _launched(f"fused_{fmt}_rfc5424_assemble")
    return flat


def encode_capnp_cuda(batch: torch.Tensor, lens: torch.Tensor,
                      channels: torch.Tensor, n: int, bank: torch.Tensor,
                      consts, OW: int = 0,
                      row_off: Optional[torch.Tensor] = None,
                      total: int = 0):
    """OC, the device capnp encode of the first ``n`` rows of an rfc5424
    ``batch`` (u8 [N, L]) from K1's packed ``channels`` (int32 [C, N] at 4
    SD blocks and 6 or 16 pairs) and the bank holding the ``capnp_extra``
    blob (``consts``: ``device_capnp.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small8 u8 [2, N])``, the tier bit before the width test, the elided
    length (0 for rows outside the tier) and fac8 / sev8, every output 0
    for rows at or past ``n``.  With ``row_off`` (int64 [N], each kept
    offset a multiple of 8: capnp rows are whole words, and the kernel
    writes their pointer words as aligned 32-bit stores) and the output
    width ``OW`` it assembles: a u8 [total] buffer holding the elided
    bytes of each row whose offset is not negative, at that offset."""
    from .rfc5424 import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    P = {n_channels(4, p): p for p in (6, 16)}.get(channels.shape[0])
    if P is None or channels.shape[1] != N or lens.shape[0] != N:
        raise ValueError("channels must be the [C, N] decode output at "
                         "max_sd=4 and 6 or 16 pairs, lens one entry per "
                         "row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_capnp")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small8 = torch.empty((2, N), dtype=torch.uint8, device=dev)
        rc = getattr(lib, f"fg_encode_capnp_probe_p{P}")(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, tier.data_ptr(), base_len.data_ptr(),
            small8.data_ptr(), _stream())
        _check(rc, "encode_capnp probe")
        _launched(f"encode_capnp_probe_p{P}")
        return tier, base_len, small8
    _need(row_off, "row_off", torch.int64, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = getattr(lib, f"fg_encode_capnp_assemble_p{P}")(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        bank.data_ptr(), consts, N, n, L, OW, row_off.data_ptr(),
        flat.data_ptr(), _stream())
    _check(rc, "encode_capnp assemble")
    _launched(f"encode_capnp_assemble_p{P}")
    return flat


def fused_capnp_out_cuda(batch: torch.Tensor, lens: torch.Tensor, n: int,
                         bank: torch.Tensor, consts, OW: int = 0,
                         row_off: Optional[torch.Tensor] = None,
                         total: int = 0, chan: Optional[torch.Tensor] = None,
                         tier: Optional[torch.Tensor] = None):
    """FO/capnp, the fused rfc5424→capnp route on the first ``n`` rows of
    ``batch`` (u8 [N, L]): K1's decode at 4 SD blocks and 6 pairs, then OC
    (``consts``: ``device_capnp.kernel_consts``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small int32 [5, N], chan int32 [N, 45], small8 u8 [2, N])``: OC's
    probe outputs, the ok, days, sod, off and nanos channels (zeros at and
    past ``n``) and the carried channels: row r of ``chan`` holds the
    :data:`FUSED_CAPNP_CARRY` channels OC's assemble reads where
    ``base[r]`` is set, and is not written elsewhere.  With ``row_off``
    (each kept offset a multiple of 8, as :func:`encode_capnp_cuda`
    needs), ``OW`` and the probe's ``chan`` and ``base`` (as ``tier``) it
    assembles from the carried channels, as :func:`fused_gelf_cuda` does:
    no decode runs again; it raises ValueError, before any launch, if a
    row it writes is not a probe tier row, or without ``chan`` or
    ``tier``."""
    assembling = row_off is not None
    if assembling and (chan is None or tier is None):
        raise ValueError("a fused assemble needs the probe's carried channels "
                         "(chan) and tier bits (tier): it does not decode "
                         "again")
    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if lens.shape[0] != N or not 4 <= L < 1 << 15:
        raise ValueError(f"bad fused geometry L={L} N={N}")
    if not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad fused geometry n={n} N={N}")
    C = FUSED_CAPNP_CARRY
    dev = batch.device
    name = "fused_rfc5424_capnp"
    if not assembling:
        base = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small = torch.empty((5, N), dtype=torch.int32, device=dev)
        small8 = torch.empty((2, N), dtype=torch.uint8, device=dev)
        carried = torch.empty((N, C), dtype=torch.int32, device=dev)
        rc = _lib("fused_capnp_out").fg_fused_rfc5424_capnp_probe(
            batch.data_ptr(), lens.data_ptr(), consts, N, n, L,
            base.data_ptr(), base_len.data_ptr(), small.data_ptr(),
            small8.data_ptr(), carried.data_ptr(), _stream())
        _check(rc, f"{name} probe")
        _launched(f"{name}_probe")
        return base, base_len, small, carried, small8
    _need(row_off, "row_off", torch.int64, 1)
    _need(chan, "chan", torch.int32, 2)
    _need(tier, "tier", torch.bool, 1)
    if row_off.shape[0] != N or OW < 1:
        raise ValueError("row_off must have one entry per row and OW be "
                         "positive")
    if chan.shape != (N, C) or tier.shape[0] != N:
        raise ValueError(f"chan must be the probe's [N, {C}] carried channels "
                         "and tier its [N] tier bits")
    # the carried channels exist only for the probe's tier rows
    if bool(((row_off >= 0) & ~tier).any()):
        raise ValueError(f"{name} assemble: row_off keeps a row outside the "
                         "probe's tier")
    return fused_capnp_out_assemble_launch(batch, lens, n, bank, consts, OW,
                                           row_off, total, chan)


def fused_capnp_out_assemble_launch(batch, lens, n: int, bank, consts,
                                    OW: int, row_off, total: int,
                                    chan) -> torch.Tensor:
    """The launch behind :func:`fused_capnp_out_cuda`'s assemble, after
    its checks (no host synchronization, so a device timing loop can
    issue it back to back); returns the u8 [total] buffer."""
    N, L = batch.shape
    flat = torch.empty(total, dtype=torch.uint8, device=batch.device)
    if total == 0:
        return flat
    rc = _lib("fused_capnp_out").fg_fused_rfc5424_capnp_assemble(
        batch.data_ptr(), lens.data_ptr(), chan.data_ptr(), bank.data_ptr(),
        consts, N, n, L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "fused_rfc5424_capnp assemble")
    _launched("fused_rfc5424_capnp_assemble")
    return flat


def _assemble_args(N: int, OW: int, ts_text, ts_len, row_off):
    from .device_common import TS_W

    _need(row_off, "row_off", torch.int64, 1)
    _need(ts_text, "ts_text", torch.uint8, 2)
    _need(ts_len, "ts_len", torch.int32, 1)
    if (row_off.shape[0] != N or ts_len.shape[0] != N
            or ts_text.shape != (N, TS_W) or OW < 1):
        raise ValueError("row_off and ts_len must have one entry per row, "
                         f"ts_text be [N, {TS_W}] and OW positive")


def encode_gelf3164_cuda(batch: torch.Tensor, lens: torch.Tensor,
                         channels: torch.Tensor, n: int, bank: torch.Tensor,
                         consts, OW: int = 0,
                         ts_text: Optional[torch.Tensor] = None,
                         ts_len: Optional[torch.Tensor] = None,
                         row_off: Optional[torch.Tensor] = None,
                         total: int = 0):
    """E3, the device GELF encode of the first ``n`` rows of an rfc3164
    ``batch`` from the D3 kernel's packed ``channels`` (int32 [12, N])
    and the constant bank (``consts``: ``device_rfc3164.kernel_consts``'s
    table).  The contract of :func:`encode_gelf_cuda`: without
    ``row_off`` the probe ``(base bool [N], base_len int32 [N])``, with it
    the assemble's u8 [total] buffer."""
    from .rfc3164 import KEYS

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if channels.shape != (len(KEYS), N) or lens.shape[0] != N:
        raise ValueError("channels must be the [12, N] rfc3164 decode output "
                         "and lens one entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_gelf")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        rc = lib.fg_encode_gelf3164_probe(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, tier.data_ptr(), base_len.data_ptr(), _stream())
        _check(rc, "encode_gelf3164 probe")
        _launched("encode_gelf3164_probe")
        return tier, base_len
    _assemble_args(N, OW, ts_text, ts_len, row_off)
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = lib.fg_encode_gelf3164_assemble(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        ts_text.data_ptr(), ts_len.data_ptr(), bank.data_ptr(), consts, N, n,
        L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "encode_gelf3164 assemble")
    _launched("encode_gelf3164_assemble")
    return flat


def encode_gelf_ltsv_cuda(batch: torch.Tensor, lens: torch.Tensor,
                          channels: torch.Tensor, n: int, bank: torch.Tensor,
                          consts, max_pairs: int, OW: int = 0,
                          ts_text: Optional[torch.Tensor] = None,
                          ts_len: Optional[torch.Tensor] = None,
                          row_off: Optional[torch.Tensor] = None,
                          total: int = 0):
    """EL, the device GELF encode of the first ``n`` rows of an ltsv
    ``batch`` at ``max_pairs`` = 6 or 16 from the L1 kernel's packed
    ``channels`` (int32 [94, N]) and the constant bank (``consts``:
    ``device_ltsv.kernel_consts``'s table).  The contract of
    :func:`encode_gelf_cuda`: without ``row_off`` the probe ``(base bool
    [N], base_len int32 [N])``, with it the assemble's u8 [total]
    buffer.  The probe also returns the narrowed stamp channels, a u8
    ``[25 N]`` buffer (``device_ltsv.small_pack``'s layout):
    ``(base, base_len, small)``."""
    from .device_ltsv import SMALL_BYTES
    from .ltsv import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if max_pairs not in (6, 16):
        raise ValueError(f"no encode_gelf_ltsv kernel for max_pairs="
                         f"{max_pairs}")
    if channels.shape != (n_channels(), N) or lens.shape[0] != N:
        raise ValueError("channels must be the [94, N] ltsv decode output "
                         "and lens one entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_gelf")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small = torch.empty(SMALL_BYTES * N, dtype=torch.uint8, device=dev)
        rc = getattr(lib, f"fg_encode_gelf_ltsv_probe_p{max_pairs}")(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, tier.data_ptr(), base_len.data_ptr(), small.data_ptr(),
            _stream())
        _check(rc, "encode_gelf_ltsv probe")
        _launched(f"encode_gelf_ltsv_probe_p{max_pairs}")
        return tier, base_len, small
    _assemble_args(N, OW, ts_text, ts_len, row_off)
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = getattr(lib, f"fg_encode_gelf_ltsv_assemble_p{max_pairs}")(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        ts_text.data_ptr(), ts_len.data_ptr(), bank.data_ptr(), consts, N, n,
        L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "encode_gelf_ltsv assemble")
    _launched(f"encode_gelf_ltsv_assemble_p{max_pairs}")
    return flat


def encode_gelf_gelf_cuda(batch: torch.Tensor, lens: torch.Tensor,
                          channels: torch.Tensor, n: int, bank: torch.Tensor,
                          consts, max_fields: int, OW: int = 0,
                          ts_text: Optional[torch.Tensor] = None,
                          ts_len: Optional[torch.Tensor] = None,
                          row_off: Optional[torch.Tensor] = None,
                          total: int = 0):
    """EG, the device GELF→GELF re-encode of the first ``n`` rows of a
    gelf ``batch`` at ``max_fields`` = 8 or 16 from K5's flat-mode
    packed ``channels`` (int32 [2 + 7 * max_fields, N]) and the constant
    bank (``consts``: ``device_gelf_gelf.kernel_consts``'s table).  The
    contract of :func:`encode_gelf_cuda`: without ``row_off`` the probe,
    which also parses each tier row's timestamp, ``(base bool [N],
    base_len int32 [N], small int32 [3, N])`` with ``small`` the
    ``ts_hi`` / ``ts_lo`` / ``ts_meta`` channels (0 off the base tier and
    at or past ``n``); with it the assemble's u8 [total] buffer."""
    from .jsonidx import n_channels

    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(channels, "channels", torch.int32, 2)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if max_fields not in (8, 16):
        raise ValueError(f"no encode_gelf_gelf kernel for max_fields="
                         f"{max_fields}")
    if channels.shape != (n_channels(max_fields), N) or lens.shape[0] != N:
        raise ValueError("channels must be the flat structural index's "
                         f"[{n_channels(max_fields)}, N] output and lens one "
                         "entry per row")
    if not 1 <= L < 1 << 15 or not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad encode geometry L={L} n={n} N={N}")
    dev = batch.device
    lib = _lib("encode_gelf")
    if row_off is None:
        tier = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        small = torch.empty((3, N), dtype=torch.int32, device=dev)
        rc = getattr(lib, f"fg_encode_gelf_gelf_probe_f{max_fields}")(
            batch.data_ptr(), lens.data_ptr(), channels.data_ptr(), consts,
            N, n, L, tier.data_ptr(), base_len.data_ptr(), small.data_ptr(),
            _stream())
        _check(rc, "encode_gelf_gelf probe")
        _launched(f"encode_gelf_gelf_probe_f{max_fields}")
        return tier, base_len, small
    _assemble_args(N, OW, ts_text, ts_len, row_off)
    flat = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return flat
    rc = getattr(lib, f"fg_encode_gelf_gelf_assemble_f{max_fields}")(
        batch.data_ptr(), lens.data_ptr(), channels.data_ptr(),
        ts_text.data_ptr(), ts_len.data_ptr(), bank.data_ptr(), consts, N, n,
        L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, "encode_gelf_gelf assemble")
    _launched(f"encode_gelf_gelf_assemble_f{max_fields}")
    return flat


def fused_gelf_cuda(fmt: str, batch: torch.Tensor, lens: torch.Tensor,
                    n: int, bank: torch.Tensor, consts, year=None,
                    OW: int = 0, ts_text: Optional[torch.Tensor] = None,
                    ts_len: Optional[torch.Tensor] = None,
                    row_off: Optional[torch.Tensor] = None, total: int = 0,
                    chan: Optional[torch.Tensor] = None,
                    tier: Optional[torch.Tensor] = None):
    """A fused route's kernel on the first ``n`` rows of ``batch`` (u8
    [N, L]): F1 for ``fmt = "rfc5424"`` (K1's decode at 6 pairs, then E1;
    ``consts`` is ``device_gelf.kernel_consts``'s table), F3 for
    ``"rfc3164"`` (D3 for ``year``, then E3; ``device_rfc3164``'s table),
    FL for ``"ltsv"`` (L1, then EL at 6 pairs; ``device_ltsv``'s
    table), FG for ``"gelf"`` (K5's flat mode at 8 fields, then EG;
    ``device_gelf_gelf``'s table).

    Without ``row_off`` it probes: ``(base bool [N], base_len int32 [N],
    small int32 [5, N], chan int32 [N, C])``, the split probe's outputs,
    the ok, days, sod, off and nanos channels (int32 [5, N], zeros at and
    past ``n``; FL: the narrowed u8 [25 N] buffer of
    ``device_ltsv.small_pack``; FG: EG's int32 [3, N] stamp channels, 0
    off its tier),
    and the carried channels: row r of ``chan`` holds the C =
    :data:`FUSED_CARRY` channels the encode reads where ``base[r]`` is
    set, and is not written elsewhere.  With ``row_off``, ``ts_text``,
    ``ts_len``, ``OW`` and the probe's ``chan`` and ``base`` (as
    ``tier``) it assembles, as :func:`encode_gelf_cuda` does, from the
    carried channels: no decode runs again.  The rows it writes (``row_off
    >= 0``) must be probe tier rows; it raises ValueError, before any
    launch, if one is not, or without ``chan`` or ``tier``.  That check
    reads one flag back from the device."""
    assembling = row_off is not None
    if assembling and (chan is None or tier is None):
        raise ValueError("a fused assemble needs the probe's carried channels "
                         "(chan) and tier bits (tier): it does not decode "
                         "again")
    _need(batch, "batch", torch.uint8, 2)
    _need(lens, "lens", torch.int32, 1)
    _need(bank, "bank", torch.uint8, 1)
    N, L = batch.shape
    if fmt not in ("rfc5424", "rfc3164", "ltsv", "gelf"):
        raise ValueError(f"no fused GELF route for {fmt}")
    if fmt == "rfc3164" and year is None and not assembling:
        raise ValueError("the rfc3164 route needs the year")
    if lens.shape[0] != N or not (4 if fmt == "rfc5424" else 1) <= L < 1 << 15:
        raise ValueError(f"bad fused geometry L={L} N={N}")
    if not 0 <= n <= N or bank.device != batch.device:
        raise ValueError(f"bad fused geometry n={n} N={N}")
    C = FUSED_CARRY[fmt]
    dev = batch.device
    name = f"fused_{fmt}_gelf"
    if not assembling:
        lib = _lib("fused_gelf")
        yr = (int(year),) if fmt == "rfc3164" else ()
        base = torch.empty(N, dtype=torch.bool, device=dev)
        base_len = torch.empty(N, dtype=torch.int32, device=dev)
        if fmt == "ltsv":
            from .device_ltsv import SMALL_BYTES

            small = torch.empty(SMALL_BYTES * N, dtype=torch.uint8,
                                device=dev)
        elif fmt == "gelf":
            small = torch.empty((3, N), dtype=torch.int32, device=dev)
        else:
            small = torch.empty((5, N), dtype=torch.int32, device=dev)
        carried = torch.empty((N, C), dtype=torch.int32, device=dev)
        rc = getattr(lib, f"fg_{name}_probe")(
            batch.data_ptr(), lens.data_ptr(), *yr, consts, N, n, L,
            base.data_ptr(), base_len.data_ptr(), small.data_ptr(),
            carried.data_ptr(), _stream())
        _check(rc, f"{name} probe")
        _launched(f"{name}_probe")
        return base, base_len, small, carried
    _assemble_args(N, OW, ts_text, ts_len, row_off)
    _need(chan, "chan", torch.int32, 2)
    _need(tier, "tier", torch.bool, 1)
    if chan.shape != (N, C) or tier.shape[0] != N:
        raise ValueError(f"chan must be the probe's [N, {C}] carried channels "
                         "and tier its [N] tier bits")
    # the carried channels exist only for the probe's tier rows
    if bool(((row_off >= 0) & ~tier).any()):
        raise ValueError(f"{name} assemble: row_off keeps a row outside the "
                         "probe's tier")
    return fused_assemble_launch(fmt, batch, lens, n, bank, consts, OW,
                                 ts_text, ts_len, row_off, total, chan)


def fused_assemble_launch(fmt: str, batch, lens, n: int, bank, consts,
                          OW: int, ts_text, ts_len, row_off, total: int,
                          chan) -> torch.Tensor:
    """The launch behind :func:`fused_gelf_cuda`'s assemble, after its
    checks (no host synchronization, so a device timing loop can issue
    it back to back); returns the u8 [total] buffer."""
    N, L = batch.shape
    name = f"fused_{fmt}_gelf"
    flat = torch.empty(total, dtype=torch.uint8, device=batch.device)
    if total == 0:
        return flat
    rc = getattr(_lib("fused_gelf"), f"fg_{name}_assemble")(
        batch.data_ptr(), lens.data_ptr(), chan.data_ptr(),
        ts_text.data_ptr(), ts_len.data_ptr(), bank.data_ptr(), consts, N, n,
        L, OW, row_off.data_ptr(), flat.data_ptr(), _stream())
    _check(rc, f"{name} assemble")
    _launched(f"{name}_assemble")
    return flat


def fused_frame_decode_rfc5424(region: torch.Tensor, rlen: int,
                               sep: int = 10, strip_cr: bool = False,
                               ncap: int = 256, max_len: int = 512,
                               max_sd: int = 4):
    """Raw region → spans → gather → RFC5424 channels, the three kernels
    chained on one stream with the dense batch internal (the CPU takes
    the plain versions).  Returns ``(spans, channels)`` with
    ``spans = {"starts", "lens", "n", "consumed", "overflow"}``; rows
    past ``spans["n"]`` decode padding and must be masked by the
    caller."""
    from .framing import gather, sep_spans
    from .rfc5424 import (DEFAULT_MAX_PAIRS, decode_rfc5424_submit,
                          unpack_channels)

    spans = sep_spans(region, rlen, sep=sep, strip_cr=strip_cr, ncap=ncap)
    batch, lens_c = gather(region, spans["starts"], spans["lens"], max_len)
    out = decode_rfc5424_submit(batch, lens_c, max_sd=max_sd)[0]
    if isinstance(out, torch.Tensor):
        out = unpack_channels(out, max_sd, DEFAULT_MAX_PAIRS)
    return spans, out


def fused_frame_decode_jsonl(region: torch.Tensor, rlen: int, sep: int = 10,
                             strip_cr: bool = True, ncap: int = 256,
                             max_len: int = 512):
    """Raw region → spans → gather → the 8-field JSON-lines structural
    index, the three kernels chained on one stream with the dense batch
    internal (the CPU takes the plain versions).  Returns ``(spans,
    channels)``; rows past ``spans["n"]`` index padding and must be
    masked by the caller."""
    from .framing import gather, sep_spans
    from .jsonidx import unpack_channels
    from .jsonl import DEFAULT_MAX_FIELDS, decode_jsonl_submit

    spans = sep_spans(region, rlen, sep=sep, strip_cr=strip_cr, ncap=ncap)
    batch, lens_c = gather(region, spans["starts"], spans["lens"], max_len)
    out = decode_jsonl_submit(batch, lens_c)[0]
    if isinstance(out, torch.Tensor):
        out = unpack_channels(out, DEFAULT_MAX_FIELDS)
    return spans, out
