"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each source under ``ops/csrc/`` compiles, on its own ``nvcc`` process (all
started together), for ``sm_90a`` into a shared library with a plain C
interface. Libraries go to ``build/kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built at
import: the first call to :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("conv_gn_mish.cu", "conv1d_gn_mish.cu", "span_stamp.cu")

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# argtypes of every C entry point, by library
SIGNATURES = {
    "conv_gn_mish.cu": {
        "adm_conv_gn_mish": [
            _P, _P, _P, _P, _P,  # x, w, bias, gamma, beta
            _I, _I, _I, _I, _I, _I, _F, _I,  # B, L, Cin, C, K, groups, eps, epi
            _P, _I, _P, _P,  # epilogue input, Ce, its weight, its bias
            _P, _I, _I, _I,  # out, x_dtype, p_dtype, out_dtype
            _I, _I, _I,  # cluster size, threads, shared-memory bytes
            _I, _I,  # one-wave path, programmatic dependent launch
            _P,  # stream
        ],
        "adm_conv_gn_mish_streamed": [
            _P, _P, _P, _P, _P,  # x, w, bias, gamma, beta
            _I, _I, _I, _I, _I, _I, _F, _I,  # B, L, Cin, C, K, groups, eps, epi
            _P, _I, _P, _P,  # epilogue input, Ce, its weight, its bias
            _P, _P, _I, _I, _I,  # out, scratch, x_dtype, p_dtype, out_dtype
            _I, _I, _I, _I, _I,  # parts, threads, shared-memory bytes; the finishing CTA's threads, bytes
            _I, _P,  # programmatic dependent launch, stream
        ],
        "adm_conv_gn_mish_folded": [
            _P, _P, _P, _P, _P,  # x, w, bias, gamma, beta
            _I, _I, _I, _I, _I, _I, _F, _I,  # B, L, Cin, C, K, groups, eps, epi
            _P, _I, _P, _P,  # epilogue input, Ce, its weight, its bias
            _P, _I, _I, _I,  # out, x_dtype, p_dtype, out_dtype
            _I, _I, _I,  # cluster size, threads, shared-memory bytes
            _I, _P,  # programmatic dependent launch, stream
        ],
        "adm_conv_gn_mish_clusters": [
            _I, _I, _I, _I, _I, _I, _I, _I,  # B, L, Cin, C, K, groups, epi, Ce
            _I, _I, _I,  # x_dtype, p_dtype, out_dtype
            _I, _I, _I, _I,  # cluster size, threads, shared-memory bytes, path (1 one-wave, 2 folded)
            _P,  # out: the clusters the card holds at once
        ],
        # CTAs, threads, cluster size (0: no cluster), shared-memory bytes, stream
        "adm_empty_launch": [_I, _I, _I, _I, _P],
    },
    "conv1d_gn_mish.cu": {
        "adm_conv1d_gn_mish": [
            _P, _P, _P, _P, _P,  # x, w, bias, gamma, beta
            _I, _I, _I, _I, _I, _I, _F,  # B, L, Cin, C, K, groups, eps
            _P, _I, _I, _I,  # out, x_dtype, p_dtype, out_dtype
            _I, _I, _I, _I, _I,  # S, copy width, stage channels, threads, shared-memory bytes
            _P,  # stream
        ],
    },
    "span_stamp.cu": {
        # ring, counter, slots, stride, marker index, last, kernel nodes out (or null), stream
        "adm_span_mark": [_P, _P, _I, _I, _I, _I, _P, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
ptxas_report: Dict[str, str] = {}  # source -> ptxas -v lines of this process's build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def _target(source: str) -> Path:
    text = b"".join(p.read_bytes() for p in [CSRC / source, *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.

    Returns the library path of each source. Raises with nvcc's output if a
    compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: _target(src) for src in SOURCES}
    procs = {}
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            continue
        ptxas_report[src] = "\n".join(
            line for line in log.splitlines() if "ptxas" in line or "registers" in line or "spill" in line
        )
        os.replace(tmp, targets[src])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built at first use."""
    lib = _loaded.get(source)
    if lib is None:
        path = build_all()[source]
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib
