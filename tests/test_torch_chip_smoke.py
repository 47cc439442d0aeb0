"""chip_smoke.py's CPU-side helpers: the ``-Xptxas -v`` resource parse
behind its ``kernel_build`` lines, and its refusal to run without a card.
The kernels' timings and checks need the card and run only there."""

import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

import chip_smoke


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread keeps this file
    from spinning a thread pool beside the other test workers (on a
    loaded box a pool of one thread a core runs the plain versions
    several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _close_the_expectation_pool():
    """The e2e helpers start chip_smoke's expectation pool on demand: stop
    its worker processes with the file, not at the interpreter's exit."""
    yield
    chip_smoke.close_expectations()


ROOT = Path(__file__).resolve().parent.parent

# the shape of nvcc 12's -Xptxas -v report for one source with two
# instantiations in an anonymous namespace
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__9519733e_17_decode_rfc5424_cu_3f9c3a4921decode_rfc5424_kernelILi4ELi16EEEvPKhPKiPiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__9519733e_17_decode_rfc5424_cu_3f9c3a4921decode_rfc5424_kernelILi4ELi16EEEvPKhPKiPiiii
    40 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 6400 bytes smem, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__67f511d1_21_frame_syslen_spans_cu_30c510b919syslen_spans_kernelEPKhiiiPiS2_S2_' for 'sm_90a'
ptxas info    : Function properties for _ZN54_GLOBAL__N__67f511d1_21_frame_syslen_spans_cu_30c510b919syslen_spans_kernelEPKhiiiPiS2_S2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_resources_per_entry_function():
    assert chip_smoke.ptxas_resources(PTXAS_LOG) == [
        {"function": "decode_rfc5424_kernel<4, 16>", "stack_bytes": 40,
         "spill_store_bytes": 8, "spill_load_bytes": 4, "registers": 62,
         "static_smem_bytes": 6400},
        {"function": "syslen_spans_kernel", "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 32,
         "static_smem_bytes": 0}]
    assert chip_smoke.ptxas_resources("") == []


def test_kernel_name_demangles_nested_names():
    assert chip_smoke.kernel_name(
        "_ZN12_GLOBAL__N_121decode_rfc5424_kernelILi4ELi6EEEvPKhPKiPiiii"
    ) == "decode_rfc5424_kernel<4, 6>"
    assert chip_smoke.kernel_name("_Z13gather_kernelPKhxPKiS2_iiPhPi") == \
        "gather_kernel"
    assert chip_smoke.kernel_name(
        "_ZN12_GLOBAL__N_118encode_gelf_kernelILi16ELb1EEEvPKhPKiS4_S2_"
        "S4_S2_NS_6ConstsEiiiiiPhPiPKlS5_") == "encode_gelf_kernel<16, true>"


def test_build_returns_the_nvcc_log_of_a_cached_library(tmp_path,
                                                        monkeypatch):
    """The ``kernel_build`` lines come from the build log, so a cached
    library must return the log of the build that made it."""
    from flowgger_tpu_torch.tpu import kernels

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != -o ]; do shift; done\n'
                    ': > "$2"\necho "ptxas info    : Used 7 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "build_dir", lambda: tmp_path / "cuda")
    fresh = kernels.build(["frame_gather"])["frame_gather"]
    cached = kernels.build(["frame_gather"])["frame_gather"]
    assert not fresh["cached"] and cached["cached"]
    assert "Used 7 registers" in fresh["log"]
    assert cached["log"] == fresh["log"]


def test_refuses_without_a_card_or_outside_a_checkout(tmp_path):
    """Alone in a directory it exits non-zero before printing a result;
    in the checkout it does the same when there is no CUDA device."""
    import torch

    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    scripts = [alone]
    if not torch.cuda.is_available():
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=300,
                              cwd=str(script.parent))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_encode_case_bound_counts_only_the_channels_needed(monkeypatch):
    """E1's chip check on the CPU with its wrapper standing in for the
    plain version: the probe's bound counts each real row's valid bytes,
    length, 14 fixed channels, the last SD id span of rows with 1-4 SD
    elements and 5 channels for each of its first min(pair_count, P)
    pairs, and every row's bit and length; the checked shape is
    recorded, and ``launch_shapes`` records a launch by its shape."""
    import torch

    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.tpu import device_gelf, kernels, pack, rfc5424

    def plain(batch, lens, ch, n, bank, table, max_sd, P, OW=0, **kw):
        assert bank.numel() and len(table) and not kw
        kernels._launched(f"encode_gelf_probe_p{P}")
        return device_gelf.encode_rows(
            batch, lens, rfc5424.unpack_channels(ch, max_sd, P),
            suffix=b"\0", max_sd=max_sd, assemble=False, n=n)

    monkeypatch.setattr(kernels, "encode_gelf_cuda", plain)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, **kw: fn() and 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, **kw: fn() and 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    lines, _ = make_corpus(64, seed=3)
    batch, lens, *_ = pack.pack_lines_2d(lines, 512)
    bt = torch.from_numpy(batch)
    lt = torch.from_numpy(lens).to(torch.int32)
    dec = rfc5424.decode_rfc5424(bt, lt, 4, 6)
    keys = [*rfc5424._KEYS_1D, *rfc5424._KEYS_SD, *rfc5424._KEYS_PAIR]
    packed = torch.cat([dec[k].to(torch.int32).reshape(bt.shape[0], -1).t()
                        for k in keys]).contiguous()
    N, n = bt.shape[0], 50
    row, = chip_smoke.encode_case(6, bt, lt, packed, n)
    pc = dec["pair_count"].to(torch.int64).clamp(0, 6)[:n]
    sdc = dec["sd_count"].to(torch.int64)[:n]
    assert (pc < 6).any() and (sdc == 0).any()
    channels = 4 * int((14 + 5 * pc + 2 * ((sdc >= 1) & (sdc <= 4))).sum())
    valid = int(lt[:n].sum())
    assert row["bound_bytes"] == valid + channels + 4 * n + 5 * N
    assert row["bound_bytes"] < valid + 4 * (14 + 8 + 30) * n + 9 * N
    assert chip_smoke.CHECKED == {("encode_gelf_probe_p6", (N, 512))}
    with chip_smoke.launch_shapes() as seen:
        kernels.encode_gelf_cuda(bt[:256], lt[:256], packed[:, :256], 256,
                                 torch.ones(1), [0], 4, 6)
    assert seen == {("encode_gelf_probe_p6", (256, 512))}


def test_host_ab_plain_side_never_loads_the_native_library(monkeypatch):
    """The host A/B's ``plain`` side runs both block encoders and the
    device tier's stamp text and splice on their plain versions, with
    the bytes of the shipped side, and never reaches the library (whose
    build here raises); the ``threads1`` side runs the library on one
    thread and restores the count."""
    import numpy as np
    import torch

    from flowgger_tpu_torch import native
    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import NulMerger
    from flowgger_tpu_torch.tpu import assemble, device_common, pack
    from flowgger_tpu_torch.tpu.encode_gelf_block import (
        encode_rfc5424_gelf_block)
    from flowgger_tpu_torch.tpu.rfc5424 import decode_rfc5424_host

    lines, _ = make_corpus(64, seed=3)
    batch, lens, chunk, starts, orig_lens, n = pack.pack_lines_2d(lines, 512)
    host = decode_rfc5424_host(torch.from_numpy(batch), torch.from_numpy(lens))
    enc = GelfEncoder(Config.from_string(""))
    small = {"ok": np.ones(3, bool), "days": np.full(3, 17000, np.int32),
             "sod": np.arange(3, dtype=np.int32),
             "off": np.zeros(3, np.int32), "nanos": np.zeros(3, np.int32)}

    def run():
        res = encode_rfc5424_gelf_block(chunk, starts, orig_lens, host, n,
                                        512, enc, NulMerger())
        cat = assemble.concat_segments(np.arange(9, dtype=np.uint8),
                                       np.array([4, 0]), np.array([3, 2]))
        return (bytes(res.block.data), bytes(cat),
                device_common.ts_text_block(small)[0].tobytes())

    shipped = run()
    threads = native._DEFAULT_THREADS
    with chip_smoke.host_side("threads1"):
        assert native._DEFAULT_THREADS == 1
        assert run() == shipped
    assert native._DEFAULT_THREADS == threads

    def no_build():
        raise AssertionError("the plain side reached the native library")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", no_build)
    with chip_smoke.host_side("plain"):
        assert run() == shipped
    assert native._lib is None


def test_ltsv_cases_check_and_record_their_shapes(monkeypatch):
    """L1's, EL's and FL's chip checks on the CPU, each wrapper standing
    in with the plain version (and counting its launch): every case runs
    its probe, its assemble and the fused route's carried selection
    through the comparisons, records its checked shapes, and a stand-in
    that differs from the plain version fails the check."""
    import pytest
    import torch

    from flowgger_tpu_torch.corpus import make_ltsv_tier_corpus
    from flowgger_tpu_torch.tpu import (device_gelf, device_ltsv,
                                        fused_routes, kernels, ltsv, pack)

    def packed_of(dec):
        rows = [dec[k].to(torch.int32) for k in ltsv.KEYS_1D]
        return torch.cat([torch.stack(rows)]
                         + [dec[k].t() for k in ltsv.KEYS_PART]).contiguous()

    def decode(b, l, n):
        kernels._launched("decode_ltsv")
        return packed_of(ltsv.decode_ltsv(b, l, n=n))

    def encode(b, l, ch, n, bank, table, P, OW=0, ts_text=None, ts_len=None,
               row_off=None, total=0):
        dec = ltsv.unpack_channels(ch)
        kw = {"suffix": b"\0", "max_pairs": P}
        if row_off is None:
            kernels._launched(f"encode_gelf_ltsv_probe_p{P}")
            base, base_len = device_ltsv.encode_rows(b, l, dec,
                                                     assemble=False, n=n,
                                                     **kw)
            return base, base_len, device_ltsv.small_pack(dec, n)
        kernels._launched(f"encode_gelf_ltsv_assemble_p{P}")
        rows, out_len, _ = device_ltsv.encode_rows(b, l, dec, ts_text,
                                                   ts_len, **kw)
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    def fused(fmt, b, l, n, bank, table, year=None, OW=0, ts_text=None,
              ts_len=None, row_off=None, total=0, chan=None, tier=None):
        dec = ltsv.decode_ltsv(b, l, n=n)
        if row_off is not None:
            return assemble_launch(fmt, b, l, n, bank, table, OW, ts_text,
                                   ts_len, row_off, total, chan)
        kernels._launched("fused_ltsv_gelf_probe")
        base, base_len = device_ltsv.encode_rows(
            b, l, dec, suffix=b"\0", assemble=False, n=n)
        carried = fused_routes.carried_plain(dec, "ltsv_gelf", b, l)
        return (base, base_len, device_ltsv.small_pack(dec, n),
                torch.where(base[:, None], carried, -1))

    def assemble_launch(fmt, b, l, n, bank, table, OW, ts_text, ts_len,
                        row_off, total, chan):
        kernels._launched("fused_ltsv_gelf_assemble")
        rows, out_len, _ = device_ltsv.encode_rows(
            b, l, ltsv.decode_ltsv(b, l, n=n), ts_text, ts_len,
            suffix=b"\0")
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    monkeypatch.setattr(kernels, "decode_ltsv_cuda", decode)
    monkeypatch.setattr(kernels, "encode_gelf_ltsv_cuda", encode)
    monkeypatch.setattr(kernels, "fused_gelf_cuda", fused)
    monkeypatch.setattr(kernels, "fused_assemble_launch", assemble_launch)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    # short rows at a narrow width: the plain versions run many times
    lines = [b"time:%d.5\thost:h%d\tk%d:v\tmessage:m" % (1760000000 + i, i,
                                                          i % 3)
             for i in range(150)] + make_ltsv_tier_corpus(30, seed=5)[0]
    batch, lens, *_ = pack.pack_lines_2d(lines, 64)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    N, n = bt.shape[0], 170
    row, ref = chip_smoke.l1_case(bt, lt, n)
    assert row["name"] == "decode_ltsv" and row["max_abs_err"] == 0.0
    assert not ref["ok"][n:].any()
    names = []
    for kind in ("el6", "el16", "fl"):
        out = chip_smoke.ltsv_route_case(kind, bt, lt, n)
        assert [r["max_abs_err"] for r in out] == [0.0, 0.0]
        assert all(r["bound_ms"] > 0 and r["bound_by"] == "bytes"
                   for r in out)
        names += [r["name"] for r in out]
    assert names == ["encode_gelf_ltsv_probe_p6",
                     "encode_gelf_ltsv_assemble_p6",
                     "encode_gelf_ltsv_probe_p16",
                     "encode_gelf_ltsv_assemble_p16", "fused_ltsv_gelf_probe",
                     "fused_ltsv_gelf_assemble"]
    assert chip_smoke.CHECKED == {(k, (N, 64)) for k in
                                  ["decode_ltsv", *names]}
    with chip_smoke.launch_shapes() as seen:
        kernels.decode_ltsv_cuda(bt, lt, n)
    assert seen == {("decode_ltsv", (N, 64))}

    def wrong(b, l, n):
        out = decode(b, l, n)
        out[ltsv.KEYS_1D.index("ts_lo")] += 1
        return out

    monkeypatch.setattr(kernels, "decode_ltsv_cuda", wrong)
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.l1_case(bt, lt, n)


def test_gelf_cases_check_and_record_their_shapes(monkeypatch):
    """K5's flat mode, EG's and FG's chip checks on the CPU, each wrapper
    standing in with the plain version (and counting its launch): every
    case runs its probe, its assemble and the fused route's carried
    selection through the comparisons, records its checked shapes under
    the names of the ``kernels`` line's new rows, and a stand-in that
    differs from the plain version fails the check."""
    import pytest
    import torch

    from flowgger_tpu_torch.corpus import make_gelf_tier_corpus
    from flowgger_tpu_torch.tpu import (device_gelf, device_gelf_gelf,
                                        fused_routes, gelf, jsonidx, kernels,
                                        pack)

    def packed_of(dec, F):
        rows = [dec[k].to(torch.int32) for k in jsonidx.KEYS_1D]
        return torch.cat([torch.stack(rows)]
                         + [dec[k].to(torch.int32).t()
                            for k in jsonidx.KEYS_F]).contiguous()

    def index(b, l, F, nested):
        assert nested == 0
        kernels._launched(f"structural_index_flat_f{F}")
        return packed_of(gelf.decode_gelf(b, l, F), F)

    def encode(b, l, ch, n, bank, table, F, OW=0, ts_text=None, ts_len=None,
               row_off=None, total=0):
        dec = jsonidx.unpack_channels(ch, F)
        if row_off is None:
            kernels._launched(f"encode_gelf_gelf_probe_f{F}")
            return device_gelf_gelf.encode_rows(b, l, dec, assemble=False,
                                                n=n, suffix=b"\0")
        kernels._launched(f"encode_gelf_gelf_assemble_f{F}")
        rows, out_len, _ = device_gelf_gelf.encode_rows(
            b, l, dec, ts_text, ts_len, suffix=b"\0")
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    def fused(fmt, b, l, n, bank, table, year=None, OW=0, ts_text=None,
              ts_len=None, row_off=None, total=0, chan=None, tier=None):
        assert fmt == "gelf"
        if row_off is not None:
            return assemble_launch(fmt, b, l, n, bank, table, OW, ts_text,
                                   ts_len, row_off, total, chan)
        kernels._launched("fused_gelf_gelf_probe")
        dec = gelf.decode_gelf(b, l)
        base, base_len, small = device_gelf_gelf.encode_rows(
            b, l, dec, suffix=b"\0", assemble=False, n=n)
        carried = fused_routes.carried_plain(dec, "gelf_gelf", b, l)
        return base, base_len, small, torch.where(base[:, None], carried, -1)

    def assemble_launch(fmt, b, l, n, bank, table, OW, ts_text, ts_len,
                        row_off, total, chan):
        kernels._launched("fused_gelf_gelf_assemble")
        rows, out_len, _ = device_gelf_gelf.encode_rows(
            b, l, gelf.decode_gelf(b, l), ts_text, ts_len, suffix=b"\0")
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    monkeypatch.setattr(kernels, "structural_index_cuda", index)
    monkeypatch.setattr(kernels, "encode_gelf_gelf_cuda", encode)
    monkeypatch.setattr(kernels, "fused_gelf_cuda", fused)
    monkeypatch.setattr(kernels, "fused_assemble_launch", assemble_launch)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    lines = make_gelf_tier_corpus(40, seed=5)[0]
    batch, lens, *_ = pack.pack_lines_2d(lines, 256)
    bt, lt = torch.from_numpy(batch[:64]), torch.from_numpy(lens[:64])
    N, n = bt.shape[0], 40
    names = []
    for F in (8, 16, 24):
        row, ref = chip_smoke.decode_case("gelf", F, bt, lt)
        assert row["max_abs_err"] == 0.0 and ref["ok"][:n].any()
        names.append(row["name"])
    for kind in ("eg8", "eg16", "fg"):
        out = chip_smoke.gelf_route_case(kind, bt, lt, n)
        assert [r["max_abs_err"] for r in out] == [0.0, 0.0]
        assert all(r["bound_ms"] > 0 and r["bound_by"] == "bytes"
                   and r["replaces"].startswith("flowgger_tpu/tpu/")
                   for r in out)
        names += [r["name"] for r in out]
    assert names == ["structural_index_flat_f8", "structural_index_flat_f16",
                     "structural_index_flat_f24",
                     "encode_gelf_gelf_probe_f8",
                     "encode_gelf_gelf_assemble_f8",
                     "encode_gelf_gelf_probe_f16",
                     "encode_gelf_gelf_assemble_f16",
                     "fused_gelf_gelf_probe", "fused_gelf_gelf_assemble"]
    assert set(names) <= set(kernels.LAUNCHES)
    assert chip_smoke.CHECKED == {(k, (N, 256)) for k in names}
    with chip_smoke.launch_shapes() as seen:
        kernels.encode_gelf_gelf_cuda(bt, lt, index(bt, lt, 8, 0), n,
                                      torch.ones(1), [0], 8)
    assert ("encode_gelf_gelf_probe_f8", (N, 256)) in seen

    def wrong(b, l, ch, n, bank, table, F, OW=0, **kw):
        got = encode(b, l, ch, n, bank, table, F, OW, **kw)
        if kw.get("row_off") is None:
            got[2][1, :] += 1            # ts_lo
        return got

    monkeypatch.setattr(kernels, "encode_gelf_gelf_cuda", wrong)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.gelf_route_case("eg8", bt, lt, n, assemble=False)


def test_gelf_phases_are_named_and_cut():
    """The gelf slice's e2e paths and their kernels, and the depth cuts
    that make room for them in the run's time budget."""
    for name in ("gelf_line", "gelf_tier"):
        fmt, framing, kind, need, need_split = chip_smoke.PATHS[name]
        assert (fmt, framing, kind) == ("gelf_tpu", "line", "gelf")
        assert "fused_gelf_gelf_probe" in need
    assert "fused_gelf_gelf_assemble" in chip_smoke.PATHS["gelf_tier"][3]
    assert "encode_gelf_gelf_assemble_f8" in chip_smoke.PATHS["gelf_tier"][4]
    assert {"structural_index_flat_f8", "encode_gelf_gelf_probe_f8",
            "encode_gelf_gelf_probe_f16"} <= set(chip_smoke.PATHS["gelf_line"][3])
    assert chip_smoke.GELF_LINES == 4 * chip_smoke.BATCH
    # cut from 4 batches (and AB_BATCHES from 2) when the LTSV-output and
    # dns paths came
    assert chip_smoke.JSONL_LINES == 2 * chip_smoke.BATCH
    assert chip_smoke.AB_BATCHES == 1


def test_auto_case_checks_and_records_its_shape(monkeypatch):
    """AC's chip check on the CPU, the wrapper standing in with the plain
    version (and counting its launch): the class codes compared on every
    real row, the shape recorded, a bytes bound over the bytes the rows
    need, and a stand-in that differs from the plain version fails."""
    import pytest
    import torch

    from flowgger_tpu_torch.corpus import AUTO_EDGE, make_auto_corpus
    from flowgger_tpu_torch.tpu import autodetect, kernels, pack

    def classify(b, l, n, dns=False):
        kernels._launched("classify_auto")
        return autodetect.classify_plain(b[:n], l[:n])

    monkeypatch.setattr(kernels, "classify_auto_cuda", classify)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    lines = list(AUTO_EDGE) + make_auto_corpus(300, seed=9)[0]
    batch, lens, *_ = pack.pack_lines_2d(lines, 128)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    row = chip_smoke.ac_case(bt, lt, len(lines))
    assert row["name"] == "classify_auto" and row["max_abs_err"] == 0.0
    assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert row["replaces"] == "flowgger_tpu/tpu/autodetect.py:97"
    assert chip_smoke.CHECKED == {("classify_auto", tuple(bt.shape))}
    with chip_smoke.launch_shapes(chip_smoke._MIXED_WRAPPERS) as seen:
        kernels.classify_auto_cuda(bt, lt, 5)
    assert seen == {("classify_auto", tuple(bt.shape))}

    def wrong(b, l, n, dns=False):
        out = classify(b, l, n)
        out[3] = (out[3] + 1) % 4
        return out

    monkeypatch.setattr(kernels, "classify_auto_cuda", wrong)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.ac_case(bt, lt, len(lines))


def test_mixed_phases_are_named_and_sized():
    """The auto and Record-path e2e paths: their formats, tables and the
    kernels each must launch; 65 536 lines an auto run and 16 384 a
    Record-path run; and the earlier paths' depths, the line mixes deep
    enough that both tiers decline and then cool."""
    paths = chip_smoke.MIXED_PATHS
    assert set(paths) == {"auto_line", "auto_tier", "record_rfc5424",
                          "record_rfc3164", "record_ltsv", "record_gelf",
                          "record_jsonl", "record_auto"}
    for name, (fmt, in_t, out_t, kind, n, need) in paths.items():
        assert fmt == ("auto_tpu" if kind == "auto" else f"{kind}_tpu")
        assert n == (chip_smoke.AUTO_LINES if name == "auto_line"
                     else chip_smoke.TIER_LINES if name == "auto_tier"
                     else chip_smoke.RECORD_LINES)
        assert "frame_sep_spans" in need
        assert ("classify_auto" in need) == (kind == "auto")
    assert chip_smoke._mixed_tables("record_ltsv")[0].count(" = ") == 10
    assert chip_smoke.AUTO_LINES == 4 * chip_smoke.BATCH
    assert chip_smoke.RECORD_LINES == chip_smoke.BATCH // 2
    assert chip_smoke.TIER_LINES == 2 * chip_smoke.BATCH
    B = chip_smoke.BATCH
    assert (chip_smoke.LTSV_LINES, chip_smoke.RFC3164_LINES,
            chip_smoke.RFC5424_LINES, chip_smoke.AB_BATCHES,
            chip_smoke.SYSLEN_LINES) == (4 * B, 4 * B, 4 * B, 1, 2 * B)
    assert set(chip_smoke.COOLING) == {"rfc5424_line", "rfc3164_line",
                                       "ltsv_line", "gelf_line",
                                       "rfc5424_ltsv_line",
                                       "rfc5424_r5_line",
                                       "rfc5424_capnp_line"}


@pytest.mark.parametrize("name", ["auto_tier", "record_rfc3164"])
def test_mixed_e2e_runs_on_the_cpu(monkeypatch, tmp_path, name):
    """phase_e2e_mixed end to end on the CPU at a small size (in process,
    with ``--device cpu``, and through the CLI only for the paths in
    ``MIXED_CLI``: neither of these; the launch checks, which need the
    card's kernels, emptied): the run byte-identical to the scalar path,
    the start-up notice where the block route cannot engage, and on the
    auto tier mix every leg's split tier taking a batch."""
    import io
    import contextlib
    import time

    import flowgger_tpu_torch

    fmt, in_t, out_t, kind, _, _ = chip_smoke.MIXED_PATHS[name]
    # enough auto rows that the 20 edge rows stay far under each leg's
    # 5 % decline threshold
    n = 5000 if kind == "auto" else 1500
    monkeypatch.setitem(chip_smoke.MIXED_PATHS, name,
                        (fmt, in_t, out_t, kind, n, ()))
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)

    def run_inproc(cfg, path):
        err, out = io.StringIO(), io.StringIO()
        saved = sys.stdin
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as raw, contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(out):
                sys.stdin = io.TextIOWrapper(io.BufferedReader(raw))
                pipe = flowgger_tpu_torch.start(str(cfg), device="cpu")
        finally:
            sys.stdin = saved
        return (time.perf_counter() - t0, pipe, err.getvalue().splitlines(),
                out.getvalue().splitlines())

    real_popen = subprocess.Popen

    def popen(argv, *a, **kw):
        if "flowgger_tpu_torch" in argv:
            kw["env"] = dict(kw["env"], OMP_NUM_THREADS="1")
            argv = [*argv, "--device", "cpu"]
        return real_popen(argv, *a, **kw)

    monkeypatch.setattr(chip_smoke, "run_inproc", run_inproc)
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    chip_smoke.phase_e2e_mixed(name, 20261016)
    rep, = emitted
    assert rep["identical_to_scalar_path"] and rep["lines"] == n
    assert "cli_wall_s" not in rep
    assert (rep["startup_notice"] is None) == (name == "auto_tier")
    if name == "auto_tier":
        assert all(rep["legs"][leg]["taken"] for leg in
                   ("rfc5424", "rfc3164", "ltsv", "gelf"))


@pytest.mark.parametrize("name", ["rfc3164_line", "gelf_line"])
def test_e2e_cli_runs_beside_the_expectation(monkeypatch, tmp_path, name):
    """phase_e2e's CLI run (``--device cpu``, started while the scalar
    expectation is made) against that expectation at a small size: its
    bytes, stderr and stdout; the in-process runs, which need the card's
    kernels, stood in for.  gelf_line's CLI run was cut when the
    transports came (it runs in process only): no CLI process starts."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    real_popen = subprocess.Popen

    started = []

    def popen(argv, *a, **kw):
        if "flowgger_tpu_torch" in argv:
            started.append(argv)
            kw["env"] = dict(kw["env"], OMP_NUM_THREADS="1")
            argv = [*argv, "--device", "cpu"]
        return real_popen(argv, *a, **kw)

    seen = []

    def e2e_inproc(nm, path, exp_out, exp_err, checked, fuse, econ=True):
        seen.append((nm, fuse, econ, len(exp_out), len(exp_err[0])))
        return {"launches": {"frame_gather": 1}, "inproc_wall_s": 1.0}

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    monkeypatch.setattr(chip_smoke, "e2e_inproc", e2e_inproc)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    total = chip_smoke.phase_e2e(name, 1200, 20261016)
    rep, = emitted
    assert rep["identical_to_scalar_path"] and rep["lines"] == 1200
    if name in chip_smoke.INPROC_ONLY:
        assert not started and "cli_wall_s" not in rep
    else:
        assert len(started) == 1
        assert rep["cli_wall_s"] > 0 and rep["output_bytes"] > 0
    assert rep["output_bytes"] > 0
    assert seen == [(name, "auto", True, rep["output_bytes"],
                     rep["error_lines"])]
    assert total == {"frame_gather": 1}


@pytest.mark.parametrize("name", ["rfc3164_tier", "gelf_tier"])
def test_e2e_tier_mix_runs_in_process_only(monkeypatch, tmp_path, name):
    """phase_e2e on a tier mix starts no CLI run (its line mix drives the
    same configuration through the CLI): the scalar expectation is made
    alone, and the in-process runs, which need the card's kernels, stood
    in for, take it with the fused route on and off (the economics off),
    and then with the fused route off and the economics on."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)

    def popen(*a, **kw):
        raise AssertionError("a tier mix started a CLI run")

    seen = []

    def e2e_inproc(nm, path, exp_out, exp_err, checked, fuse, econ=True):
        seen.append((nm, fuse, econ, len(exp_out), len(exp_err[0])))
        return {"launches": {"frame_gather": 1}, "inproc_wall_s": 1.0}

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    monkeypatch.setattr(chip_smoke, "e2e_inproc", e2e_inproc)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    total = chip_smoke.phase_e2e(name, 1200, 20261016)
    rep, = emitted
    assert rep["identical_to_scalar_path"] and rep["output_bytes"] > 0
    assert "cli_wall_s" not in rep
    # the taker runs with the economics off, then the split path with
    # it on, reported
    assert seen == [(name, f, e, rep["output_bytes"], rep["error_lines"])
                    for f, e in (("auto", False), ("off", False),
                                 ("off", True))]
    assert total == {"frame_gather": 3}


def test_out_phases_are_named_and_sized():
    """The LTSV-output, dns, syslog-output and capnp-output e2e paths:
    their formats, outputs, sizes, which run through the CLI (since the
    transports came, rfc5424_capnp_line and dns_line) and the kernels
    each must launch; the rfc5424 line mix into LTSV, RFC5424 and capnp among the
    paths whose tiers must cool."""
    paths = chip_smoke.OUT_PATHS
    B = chip_smoke.BATCH
    r5 = {"rfc5424_r5_line", "rfc5424_r5_tier", "rfc3164_r5_tier"}
    capnp = {"rfc5424_capnp_line", "rfc5424_capnp_tier", "capnp_out_rfc3164",
             "capnp_out_ltsv", "capnp_out_gelf", "capnp_out_auto",
             "capnp_out_extra", "capnp_out_jsonl"}
    syslog = {"syslog_out_gelf", "syslog_out_ltsv", "syslog_out_auto",
              "syslog_out_jsonl", "syslog_out_pass5424",
              "syslog_out_pass3164", "syslog_out_rfc3164", "syslog_out_json",
              "syslog_out_prepend"}
    assert set(paths) == {"rfc5424_ltsv_line", "rfc5424_ltsv_tier",
                          "dns_line", "dns_ltsv", "auto_dns_ltsv",
                          "ltsv_out_rfc3164", "ltsv_out_ltsv",
                          "ltsv_out_gelf", "ltsv_out_jsonl",
                          "ltsv_out_schema"} | r5 | syslog | capnp
    tiers = ("rfc5424_ltsv_tier", "rfc5424_r5_tier", "rfc3164_r5_tier",
             "rfc5424_capnp_tier")
    for name, (fmt, keys, output, kind, n, maker, cli, need,
               need_off) in paths.items():
        if name in capnp:
            assert output == "capnp"
            assert n == {"rfc5424_capnp_line": 4 * B,
                         "rfc5424_capnp_tier": 2 * B}.get(name, B // 2)
            assert cli == (name == "rfc5424_capnp_line")
            assert need[:2] == ("frame_sep_spans", "frame_gather")
            assert (need_off is None) == (name not in tiers)
            continue
        if name in r5 or name in syslog:
            assert output in ("rfc5424", "passthrough", "rfc3164", "json")
        else:
            assert output == ("gelf" if name == "dns_line" else "ltsv")
        assert n == (4 * B if name in ("rfc5424_ltsv_line",
                                       "rfc5424_r5_line")
                     else 2 * B if name in r5 or name in (
                         "rfc5424_ltsv_tier", "dns_line")
                     else B // 4 if name.startswith("syslog_out_")
                     else B // 2 if name.startswith("ltsv_out_")
                     else B)
        # rfc5424_ltsv_line's CLI run was cut when the transports came
        # (their tcp_cli_sigterm drives the LTSV output's CLI)
        assert cli == (name == "dns_line")
        assert need[:2] == ("frame_sep_spans", "frame_gather")
        assert (need_off is None) == (name not in tiers)
        assert ("decode_dns" in need) == ("dns" in name)
    assert "classify_auto_dns" in paths["auto_dns_ltsv"][7]
    assert paths["rfc5424_ltsv_tier"][8][-2:] == ("encode_ltsv_out_probe",
                                                  "encode_ltsv_out_assemble")
    assert paths["rfc5424_r5_tier"][8][-2:] == (
        "encode_rfc5424_out_probe", "encode_rfc5424_out_assemble")
    assert paths["rfc3164_r5_tier"][8][-2:] == (
        "encode_rfc3164_rfc5424_probe", "encode_rfc3164_rfc5424_assemble")
    assert "rfc5424_ltsv_line" in chip_smoke.COOLING
    assert paths["rfc5424_capnp_tier"][8][-2:] == (
        "encode_capnp_probe_p6", "encode_capnp_assemble_p6")
    assert "encode_capnp_probe_p6" in paths["capnp_out_auto"][7]
    assert "rfc5424_r5_line" in chip_smoke.COOLING
    assert "rfc5424_capnp_line" in chip_smoke.COOLING
    assert set(chip_smoke.NOTICE_PATHS) == {
        "ltsv_out_schema", "syslog_out_jsonl", "syslog_out_prepend",
        "capnp_out_jsonl"}
    assert chip_smoke._out_framing("capnp_out_extra") == "syslen"
    assert chip_smoke._masking("capnp_out_gelf") == "capnp:noop"
    assert chip_smoke._masking("rfc5424_capnp_line") == "capnp:noop"
    # record_auto's CLI run went to pay for overlap_ab (the CPU tests
    # hold the Record path's CLI against the JAX package)
    assert set(chip_smoke.MIXED_CLI) == {"auto_line"}


def test_dns_and_ac_dns_cases_check_on_the_cpu(monkeypatch):
    """DN's and AC+dns's chip checks on the CPU, the wrappers standing in
    with the plain versions (counting their launches): every channel and
    class code compared, the shape recorded, a bytes bound; a stand-in
    that differs fails."""
    import torch

    from flowgger_tpu_torch.corpus import make_auto_corpus, make_dns_corpus
    from flowgger_tpu_torch.tpu import autodetect, dns, kernels, pack

    def decode(b, l, n):
        kernels._launched("decode_dns")
        d = dns.decode_dns(b, l, n=n)
        return torch.stack([d[k].to(torch.int32) for k in dns.KEYS])

    def classify(b, l, n, dns=False):
        return autodetect.classify_plain(b[:n], l[:n], dns=dns)

    monkeypatch.setattr(kernels, "decode_dns_cuda", decode)
    monkeypatch.setattr(kernels, "classify_auto_cuda", classify)
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    lines = make_dns_corpus(400, seed=5)[0]
    batch, lens, *_ = pack.pack_lines_2d(lines, 128)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    row, ref = chip_smoke.dn_case(bt, lt, len(lines))
    assert row["name"] == "decode_dns" and row["max_abs_err"] == 0.0
    assert row["replaces"] == "flowgger_tpu/tpu/dns.py:44"
    assert row["bound_by"] == "bytes" and set(ref) == set(dns.KEYS)
    lines = make_auto_corpus(500, seed=6, dns=True)[0]
    batch, lens, *_ = pack.pack_lines_2d(lines, 128)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    row = chip_smoke.ac_case(bt, lt, len(lines), dns=True)
    assert row["name"] == "classify_auto_dns" and row["max_abs_err"] == 0.0
    assert "/jsonl/dns" in row["shape"]
    assert chip_smoke.CHECKED == {("decode_dns", (512, 128)),
                                  ("classify_auto_dns", tuple(bt.shape))}

    def wrong(b, l, n):
        out = decode(b, l, n)
        out[3, 0] += 1
        return out

    monkeypatch.setattr(kernels, "decode_dns_cuda", wrong)
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.dn_case(bt, lt, len(lines))


@pytest.mark.parametrize("name", ["dns_ltsv", "ltsv_out_schema",
                                  "syslog_out_pass3164", "syslog_out_json",
                                  "syslog_out_prepend", "capnp_out_extra",
                                  "capnp_out_gelf", "capnp_out_jsonl"])
def test_out_e2e_runs_on_the_cpu(monkeypatch, tmp_path, name):
    """phase_e2e_out end to end on the CPU at a small size (in process,
    and through the CLI where the path has one, both with ``--device
    cpu``; the launch checks, which need the card's kernels, emptied):
    byte-identical to the scalar path, the start-up notice for the typed
    schema's Record path."""
    import contextlib
    import io
    import time

    import flowgger_tpu_torch

    fmt, keys, output, kind, _, maker, cli, _, _ = chip_smoke.OUT_PATHS[name]
    monkeypatch.setitem(chip_smoke.OUT_PATHS, name,
                        (fmt, keys, output, kind, 1200, maker, cli, (),
                         None))
    monkeypatch.setattr(chip_smoke, "TIER_LAUNCHES", {})
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)

    def run_inproc(cfg, path):
        err, out = io.StringIO(), io.StringIO()
        saved = sys.stdin
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as raw, contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(out):
                sys.stdin = io.TextIOWrapper(io.BufferedReader(raw))
                pipe = flowgger_tpu_torch.start(str(cfg), device="cpu")
        finally:
            sys.stdin = saved
        return (time.perf_counter() - t0, pipe, err.getvalue().splitlines(),
                out.getvalue().splitlines())

    real_popen = subprocess.Popen

    def popen(argv, *a, **kw):
        if "flowgger_tpu_torch" in argv:
            kw["env"] = dict(kw["env"], OMP_NUM_THREADS="1")
            argv = [*argv, "--device", "cpu"]
        return real_popen(argv, *a, **kw)

    monkeypatch.setattr(chip_smoke, "run_inproc", run_inproc)
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    chip_smoke.phase_e2e_out(name, 20261016)
    rep, = emitted
    assert rep["identical_to_scalar_path"] and rep["lines"] == 1200
    assert ("cli_wall_s" in rep) == cli
    run, = rep["runs"]
    assert (run["startup_notice"] is None) == (
        name not in chip_smoke.NOTICE_PATHS)


def test_oc_cases_check_and_record_their_shapes(monkeypatch):
    """OC's and FO/capnp's chip checks on the CPU, each wrapper standing in
    with the plain version (and counting its launch): the probe, the
    assemble and the fused route's carried channels go through the
    comparisons at 6 and 16 pairs, with and without a capnp_extra, the
    rows carry the pair width in their names and a bytes bound, the
    checked shapes are recorded, and a stand-in that differs from the
    plain version fails the check."""
    import torch

    from flowgger_tpu_torch.corpus import make_tier_corpus
    from flowgger_tpu_torch.tpu import (device_capnp, device_gelf,
                                        fused_routes, kernels, pack,
                                        rfc5424)

    def packed_of(dec):
        keys = [*rfc5424._KEYS_1D, *rfc5424._KEYS_SD, *rfc5424._KEYS_PAIR]
        N = dec["ok"].shape[0]
        return torch.cat([dec[k].to(torch.int32).reshape(N, -1).t()
                          for k in keys]).contiguous()

    def decode(b, l, max_sd=4, P=6):
        return packed_of(rfc5424.decode_rfc5424(b, l, max_sd, P))

    def extras_of(table):
        return chip_smoke.CAPNP_EXTRA if table[2] else ()

    def encode(b, l, ch, n, bank, table, OW=0, row_off=None, total=0):
        P = (ch.shape[0] - 31) // 6
        dec = rfc5424.unpack_channels(ch, 4, P)
        kw = {"suffix": b"", "extras": extras_of(table)}
        if row_off is None:
            kernels._launched(f"encode_capnp_probe_p{P}")
            return device_capnp.encode_rows(b, l, dec, assemble=False, n=n,
                                            **kw)
        kernels._launched(f"encode_capnp_assemble_p{P}")
        rows, out_len, _ = device_capnp.encode_rows(b, l, dec, **kw)
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    def fused(b, l, n, bank, table, OW=0, row_off=None, total=0, chan=None,
              tier=None):
        dec = rfc5424.decode_rfc5424(b, l)
        if row_off is not None:
            # the wrapper's contract checks
            if chan is None or bool(((row_off >= 0) & ~tier).any()):
                raise ValueError("against the contract")
            return launch(b, l, n, bank, table, OW, row_off, total, chan)
        kernels._launched("fused_rfc5424_capnp_probe")
        base, base_len, small8 = device_capnp.encode_rows(
            b, l, dec, suffix=b"", extras=extras_of(table), assemble=False,
            n=n)
        live = torch.arange(b.shape[0]) < n
        small = torch.stack([torch.where(live, dec[k].to(torch.int32), 0)
                             for k in ("ok", "days", "sod", "off", "nanos")])
        carried = fused_routes.carried_plain(dec, "rfc5424_capnp")
        return (base, base_len, small,
                torch.where(base[:, None], carried, -1), small8)

    def launch(b, l, n, bank, table, OW, row_off, total, chan):
        kernels._launched("fused_rfc5424_capnp_assemble")
        rows, out_len, _ = device_capnp.encode_rows(
            b, l, rfc5424.decode_rfc5424(b, l), suffix=b"",
            extras=extras_of(table))
        return device_gelf.flat_rows(rows, out_len, row_off, total)

    monkeypatch.setattr(kernels, "decode_rfc5424_cuda", decode)
    monkeypatch.setattr(kernels, "encode_capnp_cuda", encode)
    monkeypatch.setattr(kernels, "fused_capnp_out_cuda", fused)
    monkeypatch.setattr(kernels, "fused_capnp_out_assemble_launch", launch)
    monkeypatch.setattr(device_gelf, "_bank_on",
                        lambda bank, dev: torch.frombuffer(
                            bytearray(bank), dtype=torch.uint8))
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, **kw: fn() is None or 0.0)
    monkeypatch.setattr(chip_smoke, "CHECKED", set())
    lines, _ = make_tier_corpus(300, seed=8)
    batch, lens, *_ = pack.pack_lines_2d(lines, 256)
    bt, lt = torch.from_numpy(batch), torch.from_numpy(lens)
    rows, shapes = [], []
    chip_smoke.oc_cases(bt, lt, 280, rows, shapes)
    assert [r["name"] for r in rows] == [
        "encode_capnp_probe_p6", "encode_capnp_assemble_p6",
        "encode_capnp_probe_p16", "encode_capnp_assemble_p16",
        "fused_rfc5424_capnp_probe", "fused_rfc5424_capnp_assemble"]
    assert len(shapes) == 6 and all("capnp_extra" in r["shape"]
                                    for r in shapes)
    for r in rows + shapes:
        assert r["max_abs_err"] == 0.0 and r["bound_by"] == "bytes"
        assert r["replaces"].startswith(("flowgger_tpu/tpu/device_capnp.py",
                                         "flowgger_tpu/tpu/fused_routes.py"))
    N = bt.shape[0]
    assert chip_smoke.CHECKED == {(r["name"], (N, 256)) for r in rows}

    def wrong(*a, **kw):
        out = encode(*a, **kw)
        if kw.get("row_off") is None:
            out[1][3] += 8
        return out

    monkeypatch.setattr(kernels, "encode_capnp_cuda", wrong)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.oc_case("oc", bt, lt, 280)


def test_overlap_ab_is_named_and_cut():
    """overlap_ab drives the main path and the rfc5424 tier mix at depth
    0, at the default window and at two lanes; to pay for it the syslen
    and jsonl line mixes (and the tier mixes, as before) run in process
    only, and to pay for the transports phase the ltsv and gelf line
    mixes too, rfc5424_line keeping the GELF output's CLI run."""
    assert chip_smoke.OVERLAP_PATHS == ("rfc5424_line", "rfc5424_tier")
    assert [(t, k, n) for t, k, n in chip_smoke.OVERLAP_EXECUTORS] == [
        ("inflight0", "tpu_inflight = 0\n", 1), ("inflight2", "", 1),
        ("lanes2", "tpu_lanes = 2\n", 2)]
    assert set(chip_smoke.INPROC_ONLY) == {
        "rfc5424_tier", "rfc3164_tier", "ltsv_tier", "gelf_tier",
        "rfc5424_syslen", "jsonl_line", "ltsv_line", "gelf_line"}
    assert "rfc5424_line" not in chip_smoke.INPROC_ONLY
    assert chip_smoke.RFC5424_LINES == 4 * chip_smoke.BATCH


def test_economics_notices_are_split_from_the_records_lines():
    lines = ["e1: [x]", "route economics [lane0/split]: device -> host "
             "(measured 2e-05 s/row vs 1e-05)", "e2: [y]",
             "route economics [lane1/fused]: fused -> split (measured 1e-05 "
             "s/row vs 3e-05)"]
    rest, notices = chip_smoke.econ_split(lines)
    assert rest == ["e1: [x]", "e2: [y]"] and notices == [lines[1], lines[3]]


def test_tier_mix_check_holds_the_taker_to_every_batch():
    """A tier mix's taker runs with the economics off: it must take every
    batch, send none past itself, and the other tier must see none."""
    took = {"taken": 3, "declined": 0, "cooled": 0, "econ": 0, "wide": 0,
            "tier_rows": 90, "fetch_bytes_per_tier_row": 10.0,
            "emit_bytes_per_tier_row": 20.0}
    idle = {"taken": 0, "declined": 0, "cooled": 0, "econ": 0, "wide": 0,
            "tier_rows": 0}
    chip_smoke.check_tier_mix("ok", took, idle)
    for bad_took, bad_idle in (({**took, "econ": 1}, idle),
                               (took, {**idle, "taken": 1}),
                               (took, {**idle, "econ": 1}),
                               ({**took, "declined": 1}, idle),
                               ({**took, "taken": 0}, idle),
                               (took, {**idle, "declined": 1}),
                               ({**took, "fetch_bytes_per_tier_row": 30.0},
                                idle)):
        with pytest.raises(AssertionError):
            chip_smoke.check_tier_mix("bad", bad_took, bad_idle)


def test_launch_streams_records_each_launchs_stream(monkeypatch):
    """launch_streams collects the handles ``kernels._stream`` returns
    inside the block, from every thread, and puts ``_stream`` back."""
    from flowgger_tpu_torch.tpu import kernels

    handles = iter([11, 22, 11])
    monkeypatch.setattr(kernels, "_stream", lambda: next(handles))
    fake = kernels._stream
    with chip_smoke.launch_streams() as seen:
        assert kernels._stream() == 11
        t = threading.Thread(target=kernels._stream)
        t.start()
        t.join()
        kernels._stream()
    assert seen == {11, 22} and kernels._stream is fake


def test_executor_clock_counts_pops_and_ingest_blocking():
    """executor_clock on the CPU: a two-lane handler's pops are timed a
    lane and the ingest thread's seconds in the lane set's submit and
    fence are its blocked seconds (the ingest thread is the pipeline's
    accept thread, ``input-accept``: a thread of that name pushes here);
    the class methods come back after."""
    import queue

    import torch

    from flowgger_tpu_torch.config import Config
    from flowgger_tpu_torch.corpus import make_tier_corpus
    from flowgger_tpu_torch.encoders import GelfEncoder
    from flowgger_tpu_torch.mergers import LineMerger
    from flowgger_tpu_torch.tpu import batch as B
    from flowgger_tpu_torch.tpu import overlap

    before = (B.BatchHandler._pop_emit, overlap.LaneSet.submit,
              overlap.LaneSet.fence)
    cfg = Config.from_string("[input]\ntpu_lanes = 2\ntpu_batch_size = 64\n"
                             "tpu_encode_economics = false\n")
    tx = queue.Queue()
    lines, _ = make_tier_corpus(256, seed=5)
    with chip_smoke.executor_clock() as clock:
        # made inside the block, as run_inproc makes its pipeline's: the
        # lane set binds the handler's pop at construction
        h = B.BatchHandler(tx, GelfEncoder(cfg), cfg, LineMerger(),
                           torch.device("cpu"), start_timer=False)

        def ingest():
            for ln in lines:
                h.handle_bytes(ln)
            h.flush()

        t = threading.Thread(target=ingest, name="input-accept")
        t.start()
        t.join(60)
    h.close()
    assert (B.BatchHandler._pop_emit, overlap.LaneSet.submit,
            overlap.LaneSet.fence) == before
    assert clock["pops"] == 4 and set(clock["pop_s"]) == {0, 1}
    assert clock["blocked_s"] > 0 and tx.qsize() == 4


def test_transports_phase_at_a_small_size_on_the_cpu(monkeypatch, tmp_path):
    """phase_transports end to end on the CPU at a small size (the
    pipelines on ``cpu``, the CLI with ``--device cpu``): each run's
    bytes against its expectation, tcp_conns' records a connection in
    order, udp_dgram's datagrams through ``ingest_spans``, scalar_tcp
    launching nothing, tcp_cli_sigterm exiting 0.  Launch counts stay 0
    on the CPU, so the on-card checks are stood in for."""
    import torch

    from flowgger_tpu_torch import pipeline as P
    from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(P, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    needs = []
    monkeypatch.setattr(chip_smoke, "_need_rfc5424",
                        lambda name, launches, framed=True:
                        needs.append((name, framed)))
    real_popen = subprocess.Popen

    def popen(argv, *a, **kw):
        if "flowgger_tpu_torch" in argv:
            kw["env"] = dict(kw["env"], OMP_NUM_THREADS="1")
            argv = [*argv, "--device", "cpu"]
        return real_popen(argv, *a, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    for name, n in (("UDP_DGRAMS", 400), ("SCALAR_TCP_LINES", 300),
                    ("SIGTERM_LINES", 400)):
        monkeypatch.setattr(chip_smoke, name, n)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    lines, _ = make_corpus(1024, 9)
    data = b"\n".join(lines)
    exp_out, exp_err = scalar_expectation(data)
    monkeypatch.setitem(chip_smoke.EXPECTED, "rfc5424_line",
                        (1024, 9, None, data, exp_out, (exp_err, [])))
    monkeypatch.setattr(chip_smoke, "LATE", set())
    chip_smoke.phase_transports(9)
    runs = {r["run"]: r for r in emitted}
    assert list(runs) == ["tcp_line", "tcp_conns", "udp_dgram",
                          "scalar_tcp", "tcp_cli_sigterm"]
    assert runs["tcp_line"]["identical_to_expectation"]
    assert runs["tcp_conns"]["identical_as_multiset_and_in_order_a_connection"]
    assert runs["tcp_conns"]["batches"] >= runs["tcp_line"]["batches"]
    assert runs["udp_dgram"]["ingest_spans"]["datagrams"] > 300
    assert runs["udp_dgram"]["lost_records"] <= 4
    assert runs["scalar_tcp"]["identical_to_rfc5424_tpu"]
    assert runs["tcp_cli_sigterm"]["exit_code"] == 0
    assert runs["tcp_cli_sigterm"]["output"] == "ltsv"
    assert needs == [("tcp_line", True), ("tcp_conns", True),
                     ("udp_dgram", False), ("scalar_tcp", True)]


def test_expectation_pool_checks_the_inputs_hash(monkeypatch, tmp_path):
    """A pool worker writes a path's input and its scalar expectation
    (the same bytes the parent made before the pool came); the pick-up
    fails once the input file differs from the one the expectation was
    made from."""
    from flowgger_tpu_torch.corpus import scalar_expectation

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    job = chip_smoke._paths_job("rfc5424_line", 300, 7)
    path, data, exp_out, errs, notices, since, mix = chip_smoke.expected(job)
    assert path == tmp_path / "rfc5424_line.in"
    assert (exp_out, errs) == scalar_expectation(data)
    assert notices == [] and sum(mix.values()) == 300
    assert since <= chip_smoke.time.time()
    path.write_bytes(data.replace(b"<", b"[", 1))
    with pytest.raises(AssertionError, match="not the one its scalar"):
        chip_smoke.expected(job)


def test_redis_kafka_expectation_takes_each_element_whole():
    """redis_kafka's expectation hands each list element to the decoder
    whole, as the redis input hands it to its handler: an empty element
    prints its error line (a NUL splitter would skip it)."""
    from flowgger_tpu_torch.corpus import capnp_messages

    ok = b"<13>1 2015-08-05T15:53:45Z h a p m - ok"
    data = b"\0".join([ok, b"", ok])
    out, errs, notices = chip_smoke._expectation(chip_smoke._sinks_job(3),
                                                 data)
    assert errs == ["Unsupported BOM: []"] and notices == []
    assert len(capnp_messages(out)) == 2


def test_wait_expectations_blocks_until_the_pool_is_done(monkeypatch,
                                                         tmp_path):
    """wait_expectations returns once every queued job is done, and adds
    the seconds it blocked to the pool's wait."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    before = chip_smoke.POOL["wait_s"]
    chip_smoke.submit_expectation(chip_smoke._paths_job("rfc5424_line", 64,
                                                        5))
    chip_smoke.wait_expectations()
    assert all(f.done() for f in chip_smoke.POOL["jobs"].values())
    assert chip_smoke.POOL["wait_s"] > before


def test_expectation_jobs_cover_every_e2e_path():
    """The pool is queued with every e2e path and the sinks phase's
    redis_kafka, in the order the phases take them, at their sizes."""
    jobs = chip_smoke.expectation_jobs(20261016, 65536)
    names = [j["name"] for j in jobs]
    assert names == [*chip_smoke.PATHS, *chip_smoke.MIXED_PATHS,
                     *chip_smoke.OUT_PATHS, "redis_kafka",
                     "serving_limited", "serving_heavy", "serving_default",
                     "serving_enrich", "serving_breaker"]
    by = {j["name"]: j for j in jobs}
    assert by["jsonl_line"]["lines"] == chip_smoke.JSONL_LINES
    assert by["rfc5424_line"]["lines"] == 65536
    assert by["redis_kafka"]["lines"] == chip_smoke.REDIS_KAFKA_LINES
    assert by["serving_enrich"]["lines"] == 65536
    assert by["serving_breaker"]["lines"] == (chip_smoke.BREAKER_HEAD
                                              + chip_smoke.BREAKER_TAIL)
    assert chip_smoke.pool_workers() >= 1


def test_sinks_phase_at_a_small_size_on_the_cpu(monkeypatch, tmp_path):
    """phase_sinks end to end on the CPU at a small size (the pipelines
    on ``cpu``): redis_kafka's records, from the RespFake through the
    redis input and the Kafka sink into the KafkaFake, in order against
    the pool's scalar expectation, every batch's CRC32C checked and
    snappy-decompressed by the fake; file_rotate's files concatenating
    to rfc5424_line's expectation.  Launch counts stay 0 on the CPU, so
    the on-card checks are stood in for."""
    from flowgger_tpu_torch import pipeline as P
    from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(P, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    needs = []
    monkeypatch.setattr(chip_smoke, "_need_rfc5424",
                        lambda name, launches, framed=True:
                        needs.append(name))
    monkeypatch.setattr(chip_smoke, "_need_capnp",
                        lambda name, launches: needs.append(name))
    for name, n in (("REDIS_KAFKA_LINES", 256), ("ROTATE_SIZE", 48 << 10),
                    ("ROTATE_BUFFER", 4096), ("RESP_LOOP_LINES", 64)):
        monkeypatch.setattr(chip_smoke, name, n)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    lines, _ = make_corpus(1024, 9)
    data = b"\n".join(lines)
    path = tmp_path / "rfc5424_line.in"
    path.write_bytes(data)
    exp_out, exp_err = scalar_expectation(data)
    monkeypatch.setitem(chip_smoke.EXPECTED, "rfc5424_line",
                        (1024, 9, path, data, exp_out, (exp_err, [])))
    monkeypatch.setattr(chip_smoke, "LATE", set())
    chip_smoke.phase_sinks(9)
    runs = {r["run"]: r for r in emitted}
    assert list(runs) == ["redis_kafka", "file_rotate"]
    rk = runs["redis_kafka"]
    assert rk["records_identical_in_order"] and rk["lines"] == 256
    assert rk["kafka"]["checksums_valid"] and rk["kafka"]["compression"] == [2]
    assert rk["produce_requests"] == rk["kafka"]["batches"] >= 1
    assert rk["resp_round_trips_per_line"] >= 2
    assert rk["resp_loop_alone_lines_per_s"] > 0
    fr = runs["file_rotate"]
    assert fr["concatenation_identical"] and fr["files"] >= 3
    assert sum(fr["file_bytes"]) == len(exp_out)
    assert needs == ["redis_kafka", "file_rotate"]


def test_serving_phase_at_a_small_size_on_the_cpu(monkeypatch, tmp_path):
    """phase_serving end to end on the CPU at a small size (the pipelines
    on ``cpu``): tenants_tcp's three tenants from 127.0.0.1/.2/.3 (the
    limited one shed, in whole regions, the others whole and in order),
    the enrichment run against the scalar path with the same miner and
    the mining-only run against rfc5424_line's expectation, breaker_trip's
    one trip, probes and close, queue_drop's shed items.  Launch counts
    stay 0 on the CPU, so the on-card checks are stood in for."""
    from flowgger_tpu_torch import pipeline as P
    from flowgger_tpu_torch.corpus import make_corpus, scalar_expectation

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    monkeypatch.setattr(P, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    needs = []
    monkeypatch.setattr(chip_smoke, "_need_serving",
                        lambda name, launches, need: needs.append(name))
    for name, n in (("SERVING_LINES", 600), ("SERVING_RATE", 100),
                    ("BREAKER_BATCH", 64), ("BREAKER_HEAD", 640),
                    ("BREAKER_TAIL", 1500), ("QUEUE_BATCH", 64)):
        monkeypatch.setattr(chip_smoke, name, n)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    lines, _ = make_corpus(1024, 9)
    data = b"\n".join(lines)
    path = tmp_path / "rfc5424_line.in"
    path.write_bytes(data)
    exp_out, exp_err = scalar_expectation(data)
    monkeypatch.setitem(chip_smoke.EXPECTED, "rfc5424_line",
                        (1024, 9, path, data, exp_out, (exp_err, [])))
    monkeypatch.setattr(chip_smoke, "LATE", set())
    monkeypatch.setattr(chip_smoke, "BREAKER_CLOSED", ["e2e"])
    chip_smoke.phase_serving(9, 1024)
    runs = {r["run"]: r for r in emitted}
    assert list(runs) == ["tenants_tcp", "templates_enrich",
                          "templates_mine", "breaker_trip", "queue_drop",
                          "breaker_closed"]
    tt = runs["tenants_tcp"]
    assert tt["in_order_subsequence_a_tenant"]
    assert tt["records_per_tenant"]["limited"] < 600
    assert tt["limited_lines_shed"] > 0
    assert tt["queue"] == "WeightedFairQueue"
    assert runs["templates_enrich"]["notice"] and \
        runs["templates_mine"]["notice"] == []
    bt = runs["breaker_trip"]
    assert bt["trips"] == 1 and bt["probes"] >= 1
    assert bt["transitions"][0] == "open" and bt["transitions"][-1] == "closed"
    qd = runs["queue_drop"]
    assert qd["items_shed"] >= 1 and qd["output_is_expectation_less_the_shed_items"]
    assert runs["breaker_closed"]["runs_held_closed"] >= 4
    assert needs == ["tenants_tcp", "templates_enrich", "templates_mine",
                     "breaker_trip", "queue_drop"]


def test_kafka_fake_refuses_a_bad_crc32c():
    """KafkaFake's own check: a record batch whose CRC32C does not match
    its post-CRC bytes fails :meth:`KafkaFake.records`."""
    from flowgger_tpu_torch.utils.kafka_wire import _record_batch

    batch = bytearray(_record_batch([b"a", b"bc"], "snappy", now_ms=5))
    with chip_smoke.KafkaFake() as fake:
        fake.sets.append((3, bytes(batch)))
        assert fake.records()[0] == [b"a", b"bc"]
        batch[-1] ^= 1
        fake.sets[:] = [(3, bytes(batch))]
        with pytest.raises(AssertionError, match="CRC32C"):
            fake.records()
