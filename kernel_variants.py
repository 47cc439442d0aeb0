"""Text-substituted variants of the port's CUDA sources, built and timed
on one card.

    python3 kernel_variants.py PRESET | SPEC.json

A spec maps a variant name to ``{"source": "decode_rfc5424" |
"fused_gelf", "route": "rfc5424" | "rfc3164" (fused_gelf only),
"subs": {file: [[old, new], ...]}}``.  Each variant is a copy of
``flowgger_tpu_torch/csrc`` under ``build/variants/<name>`` with the
substitutions applied (each ``old`` must occur), compiled with the
port's ``nvcc`` flags, all variants at once.  For each it prints one
JSON line per entry function with the ptxas resources, then one with
the device ms (``chip_smoke.device_ms``, three repeats) of K1 at 6 pairs
or of the fused route's probe on a gathered [16384, 512] batch of the
route's tier mix, and whether its outputs equal those of the first
variant of the same kernel.  A variant that cuts a phase out to time it
differs by design.

Presets: ``k1-phases`` (K1 as shipped and with the class masks, the
header passes 2-3 or passes 5-6 cut out: what each phase costs) and
``probe-bounds`` (the fused probes at explicit launch bounds).  It is
for exploring a kernel: the kernels the port ships are the ones
``chip_smoke.py`` builds and holds against their plain versions.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "flowgger_tpu_torch" / "csrc"
OUT = ROOT / "build" / "variants"

_ROW = "decode_rfc5424_row.cuh"
_LB = ("__launch_bounds__(32 * kWarps,\n"
       "                                  ASM ? kMinBlocks : kProbeBlocks{})")


def _k1(subs=None):
    return {"source": "decode_rfc5424", "subs": subs or {}}


def _probe(route, blocks=None):
    subs = {}
    if blocks is not None:
        old = _LB.format("5" if route == "rfc5424" else "3")
        subs["fused_gelf.cu"] = [[old, old.replace(
            old.split(": ")[1], f"{blocks})")]]
    return {"source": "fused_gelf", "route": route, "subs": subs}


PRESETS = {
    "k1-phases": {
        "k1": _k1(),
        "k1_no_masks": _k1({_ROW: [[
            "const int nwords = (n + 31) >> 5;", "const int nwords = 0;"]]}),
        "k1_no_passes_2_3": _k1({_ROW: [[
            "  zone_end = zone_end < m ? zone_end : m;\n",
            "  zone_end = 0;\n"]]}),
        "k1_no_passes_5_6": _k1({_ROW: [
            ["  for (int w = lane; w < nwords; w += 32) {\n"
             "    const uint32_t out = MW(M_OUT, w), rest",
             "  for (int w = lane; w < 0; w += 32) {\n"
             "    const uint32_t out = MW(M_OUT, w), rest"],
            ["    for (int w = lane; w < nwords; w += 32) {\n"
             "      const uint32_t in_pair = pair_bits(w)",
             "    for (int w = lane; w < 0; w += 32) {\n"
             "      const uint32_t in_pair = pair_bits(w)"]]}),
    },
    "probe-bounds": {
        **{f"f1_min{b}": _probe("rfc5424", b) for b in (1, 4, 5)},
        **{f"f3_min{b}": _probe("rfc3164", b) for b in (1, 5, 6)},
    },
}


def build(spec: dict) -> dict:
    from flowgger_tpu_torch.tpu import kernels as K

    procs = {}
    for name, v in spec.items():
        vd = OUT / name
        if vd.exists():
            shutil.rmtree(vd)
        shutil.copytree(CSRC, vd)
        for f, subs in v["subs"].items():
            text = (vd / f).read_text()
            for old, new in subs:
                if old not in text:
                    raise ValueError(f"{name}: {f} has no {old[:60]!r}")
                text = text.replace(old, new)
            (vd / f).write_text(text)
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(vd / "lib.so"),
               str(vd / f"{v['source']}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode("utf-8", "replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        import chip_smoke as cs

        for r in cs.ptxas_resources(log):
            print(json.dumps({"variant": name, **r}), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn, args in K._SIGNATURES[spec[name]["source"]].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(args), ctypes.c_int
        libs[name] = lib
    return libs


def tier_batch(route: str):
    import chip_smoke as cs
    from flowgger_tpu_torch.corpus import (make_rfc3164_tier_corpus,
                                           make_tier_corpus)
    from flowgger_tpu_torch.tpu import framing, pack

    make = make_tier_corpus if route == "rfc5424" else \
        make_rfc3164_tier_corpus
    region_b = b"\n".join(make(cs.BATCH, 21)[0]) + b"\n"
    region = cs.upload(region_b)
    spans = framing.sep_spans(region, len(region_b), 10, True,
                              pack.bucket_rows(cs.BATCH))
    return framing.gather(region, spans["starts"], spans["lens"], cs.MAX_LEN)


def launcher(v: dict, lib, batches: dict):
    """(call, outputs) of one variant's kernel on its batch."""
    import torch

    from flowgger_tpu_torch.tpu import device_gelf, device_rfc3164
    from flowgger_tpu_torch.tpu import kernels as K
    from flowgger_tpu_torch.utils.timeparse import current_year_utc

    route = v.get("route", "rfc5424")
    b, ln = batches[route]
    N, L = b.shape
    dev = b.device
    if v["source"] == "decode_rfc5424":
        out = torch.empty((23 + 2 * 4 + 6 * 6, N), dtype=torch.int32,
                          device=dev)

        def call():
            return lib.fg_decode_rfc5424_sd4_p6(
                b.data_ptr(), ln.data_ptr(), out.data_ptr(), N, L, K._stream())
        return call, lambda: (out.clone(),)
    split = device_gelf if route == "rfc5424" else device_rfc3164
    _, table = split.kernel_consts(b"\0")
    tier = torch.empty(N, dtype=torch.bool, device=dev)
    base_len = torch.empty(N, dtype=torch.int32, device=dev)
    small = torch.empty((5, N), dtype=torch.int32, device=dev)
    chan = torch.zeros((N, K.FUSED_CARRY[route]), dtype=torch.int32,
                       device=dev)
    fn = getattr(lib, f"fg_fused_{route}_gelf_probe")
    yr = () if route == "rfc5424" else (current_year_utc(),)

    def call():
        return fn(b.data_ptr(), ln.data_ptr(), *yr, table, N, N, L,
                  tier.data_ptr(), base_len.data_ptr(), small.data_ptr(),
                  chan.data_ptr(), K._stream())
    return call, lambda: (tier.clone(), base_len.clone(), small.clone(),
                          torch.where(tier[:, None], chan, 0))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(cs.phase_device(), flush=True)
    spec = PRESETS.get(argv[0])
    if spec is None:
        spec = json.loads(Path(argv[0]).read_text())
    libs = build(spec)
    routes = {v.get("route", "rfc5424") for v in spec.values()}
    batches = {r: tier_batch(r) for r in routes}
    first = {}
    for name, lib in libs.items():
        call, outputs = launcher(spec[name], lib, batches)
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        got = outputs()
        key = (spec[name]["source"], spec[name].get("route"))
        same = None
        if key in first:
            same = all(torch.equal(x, y) for x, y in zip(got, first[key]))
        else:
            first[key] = got
        print(json.dumps({"variant": name, "same_as_first": same,
                          "ms": [cs.device_ms(call) for _ in range(3)]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
