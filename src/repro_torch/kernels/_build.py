"""Build and load the hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together; a source listed in ``PARTS`` by
one process a part), the objects are linked into one shared library with
a plain C interface, and the library is loaded with ``ctypes``. The build goes into ``kernels/build/<hash of sources and
flags>/`` (listed in ``.gitignore``), so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# sources compiled in parts, one nvcc a part with -DH2EAL_PART=i, all at
# once: each part holds a share of the source's template instantiations
# (paged_attention.cu: one dtype and split kind each, for the groups up to
# 8 and for the group of 16; flash_attention_bwd.cu: one dtype each of its
# kernels, the f32 route with the C entry and the bf16 FMA kernels)
PARTS = {"paged_attention.cu": 8, "flash_attention_bwd.cu": 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: (argument types); each returns a cudaError_t as int
SIGNATURES = {
    # flash_attention: f32 on the FMA units, bf16 on the tensor cores; the
    # fifth pointer is null or the rows' log-sum-exp (B, Hq, Sq) f32
    "h2eal_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P),
    "h2eal_flash_attention_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _P),
    # paged_attention: a contiguous buffer (slots null) or a page table,
    # split over unit ranges or page stripes (the last _I: the mode)
    "h2eal_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _L, _I, _I, _F, _P),
    "h2eal_page_score": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # page_score's select mode: score, top-k, importance, keep, in one launch
    "h2eal_page_select": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P),
    # chunk_attention(_paged): f32 on the FMA units, bf16 on the tensor cores
    "h2eal_chunk_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "h2eal_chunk_attention_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _P),
    "h2eal_chunk_attention_paged": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _P),
    "h2eal_chunk_attention_paged_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _I, _F, _P),
    "h2eal_combine_partials": (_P, _P, _P, _P, _I, _I, _I, _P),
    # flash_attention's backward: q, k, v, o, dO, the forward's row
    # log-sum-exp (f32), dq, dk, dv, the f32 row scratch Δ, key tile 0's
    # parts (f32, or null) and their int32 arrival counters, then dtype, b,
    # sq, sk, hq, hkv, d, causal, window, sink, q_offset, scale, stream
    "h2eal_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the CUDA "
                       "kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(PARTS.items()))).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library.

    Returns the library's path.
    """
    out_dir = BUILD / _digest()
    lib = out_dir / "libh2eal_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        n = PARTS.get(src.name)
        for i in range(n) if n else [None]:
            tag = src.stem if i is None else f"{src.stem}.part{i}"
            obj = tmp / (tag + ".o")
            define = [] if i is None else [f"-DH2EAL_PART={i}"]
            cmd = [nvcc, *NVCC_FLAGS, *define, "-c", str(src), "-o", str(obj)]
            procs.append((tag, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for tag, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {tag}\n{text}")
        if proc.returncode != 0:
            failed.append(tag)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    part = tmp / lib.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(part), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(part, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


# queries that return a count, not a cudaError_t: (argument types, result)
QUERIES = {
    # f32 floats of the backward's scratch for key tile 0's parts: dtype, d,
    # b, sq, hkv, window, sink
    "h2eal_flash_attention_bwd_parts": ((_I, _I, _I, _I, _I, _I, _I), _L),
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        lib.h2eal_error_string.argtypes = [ctypes.c_int]
        lib.h2eal_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().h2eal_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")

