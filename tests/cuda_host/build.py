"""Build a kernel source of ``flowgger_tpu_torch/csrc`` for the CPU with
g++ and the host emulation header beside this file (cuda_runtime.h).

The launch syntax and the dynamic shared-memory declaration are the only
CUDA-only constructs the sources use; they are rewritten here, and every
other line compiles as written.  A source's ``#include "name.cuh"``
headers (beside it in ``csrc/``) are inlined, each once, as ``#pragma
once`` has nvcc include them, and rewritten the same way.  A probe
beside this file may ``#include "name.cu"`` a kernel source to call its
device functions; the include is inlined the same way.  Returns the path of a
shared library with the source's ``extern "C"`` entry points, called
through ctypes with host pointers exactly as
``flowgger_tpu_torch.tpu.kernels`` calls the device build.  ``src_dir``
points elsewhere for the emulation's own probes (``intrinsics_probe.cu``,
``lookback_probe.cu`` and ``barrier_probe.cu`` beside this file).

Libraries are kept in ``build/cuda_host`` at the repo root (listed in
``.gitignore``), keyed by a hash of the rewritten source, the emulation
header and the flags, so the test files that check the same source
compile it once between them; a library is published with an atomic
rename, so two test workers that build it at once both load a whole one.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent.parent / "flowgger_tpu_torch" / "csrc"
CACHE = HERE.parent.parent / "build" / "cuda_host"
# a misaligned access traps here as it faults on the card (a 16-byte
# vector load or store off a 16-byte boundary, an unaligned int)
FLAGS = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-fsanitize=alignment", "-fsanitize-undefined-trap-on-error"]


def host_source(text: str, seen=None) -> str:
    # a kernel source's headers, and a kernel source a probe includes to
    # reach its device functions, inlined once each
    seen = set() if seen is None else seen

    def inline(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        return host_source((CSRC / name).read_text(), seen)

    text = text.replace("#pragma once\n", "")
    text = re.sub(r'#include "(\w+\.cuh?)"', inline, text)
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(g_dyn_smem.data());", text)
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text,
                  flags=re.S)


def gxx_available() -> bool:
    return shutil.which("g++") is not None


def build(name: str, out_dir: Path, src_dir: Path = CSRC) -> Path:
    text = host_source((src_dir / f"{name}.cu").read_text())
    key = hashlib.sha256("\0".join(
        [text, (HERE / "cuda_runtime.h").read_text(), *FLAGS]).encode())
    lib = CACHE / f"lib{name}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    src = out_dir / f"{name}.cpp"
    src.write_text(text)
    tmp = out_dir / f"lib{name}.so"
    subprocess.run(["g++", *FLAGS, "-I", str(HERE), "-o", str(tmp),
                    str(src)], check=True, capture_output=True, text=True)
    CACHE.mkdir(parents=True, exist_ok=True)
    part = lib.with_suffix(f".{os.getpid()}.part")
    shutil.copyfile(tmp, part)
    os.replace(part, lib)
    return lib
