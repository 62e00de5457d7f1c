"""Build the Hopper kernels in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` into an object file; the objects are linked into
one shared library with a plain C interface. Sources include no PyTorch
header, so a build takes seconds. The library lands in ``build/repro_torch/``
at the repository root (git-ignored), named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as is.

Nothing here runs at import: ``library()`` builds and loads on its first
call, which is the first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (pointers and the stream as void*, so ctypes
# never narrows a 64-bit address to a 32-bit int)
_SIGNATURES = {
    # dtype, D; q k v o lse (null: none); B Hq Hkv Sq Sk causal window;
    # softcap scale; q_offset sk_valid block_q block_k; the stream
    "repro_flash_attention": [_I, _I] + [_P] * 5 + [_I] * 7 + [_F, _F]
    + [_I] * 4 + [_P],
    # dtype, D; q k v o dO lse dq dk dv, the scratch (delta, dK and dV
    # shares); B Hq Hkv Sq Sk causal window; softcap scale; the stream
    "repro_flash_attention_bwd": [_I, _I] + [_P] * 12 + [_I] * 7 + [_F, _F]
    + [_P],
    "repro_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _F, _I, _P],
    "repro_paged_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "repro_paged_decode_attention_int8": [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                          _F, _I, _P],
    # dtype, D; q k_pool v_pool table kv_len q_offset o; Hq Hkv C block_size
    # max_blocks window; softcap scale; the stream
    "repro_paged_chunk_attention": [_I, _I] + [_P] * 7 + [_I] * 6
    + [_F, _F] + [_P],
    # dtype, N; x dt A B C y final_state states totals; B H S P chunk
    # passes groups; the stream
    "repro_ssd_scan": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _P],
    # x w_up w_down token slot gate offsets tile_start h y; E d f tiles
    # passes; the stream
    "repro_moe_experts": [_P] * 10 + [_I] * 5 + [_P],
    # dtype, N; x dt A B C dy dfinal, the forward's workspace (states,
    # totals), the scratch (dstates, dB/dC shares, steps, dA shares), dx
    # ddt dA dB dC; B H S P chunk; the stream
    "repro_ssd_scan_bwd": [_I, _I] + [_P] * 19 + [_I] * 5 + [_P],
}


@dataclass
class BuildInfo:
    path: str            # the shared library loaded
    built: bool          # compiled by this process (False: found on disk)
    seconds: float       # compile + link wall time (0 when found)
    log: str             # nvcc's output, including -Xptxas -v


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the Hopper kernels "
                       "build only where the CUDA toolkit is installed")


def _compile(lib_path: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent build of the same hash is harmless)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs, failed = [], [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== nvcc {src.name}\n{out}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = work / lib_path.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, lib_path)
        return "\n".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib, _info
    if _lib is not None:
        return _lib
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    t0 = time.perf_counter()
    built, log = False, ""
    if not lib_path.exists():
        log = _compile(lib_path)
        built = True
    seconds = time.perf_counter() - t0 if built else 0.0
    lib = bind(lib_path)
    _lib, _info = lib, BuildInfo(str(lib_path), built, seconds, log)
    return lib


def bind(lib_path) -> ctypes.CDLL:
    """The shared library at ``lib_path`` loaded, each entry point given
    its C signature."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build_info() -> BuildInfo:
    """How the library was obtained (builds it if it is not loaded yet)."""
    library()
    return _info


def check(code: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")
