"""Build kernel sources of ``flowgger_tpu_torch/csrc`` (and the
emulation's own probes beside this file) for the CPU with ``build.py``,
in parallel, and bind their entry points with the signatures
``flowgger_tpu_torch.tpu.kernels`` binds the device builds with.  Shared
by the ``tests/test_torch_*_kernel_source*.py`` files, each of which
builds only the sources it checks."""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import build as host_build

P, I = ctypes.c_void_p, ctypes.c_int
# the emulation's probes beside this file: their source and entry points
PROBES = {
    "probe": ("intrinsics_probe", {"fg_probe_intrinsics": (P, P, P)}),
    "lookback": ("lookback_probe", {"fg_probe_lookback": (P, P, I, P)}),
    "barriers": ("barrier_probe", {"fg_probe_barriers": (I, P)}),
}


def load(names, out: Path) -> dict:
    """``{name: ctypes.CDLL}`` for kernel sources (``kernels._SOURCES``
    names) and probes (:data:`PROBES` names), every entry point bound."""
    from flowgger_tpu_torch.tpu.kernels import _SIGNATURES

    def one(name):
        if name in PROBES:
            return host_build.build(PROBES[name][0], out, host_build.HERE)
        return host_build.build(name, out)

    with ThreadPoolExecutor(len(names)) as ex:
        paths = dict(zip(names, ex.map(one, names)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        sigs = PROBES[name][1] if name in PROBES else _SIGNATURES[name]
        for fn, args in sigs.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(args), I
        libs[name] = lib
    return libs
