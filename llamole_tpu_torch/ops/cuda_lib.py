"""Build and load the port's CUDA kernels.

Route: `nvcc` compiles each csrc/*.cu for sm_90a into an object file, all
sources at once in parallel, and links them into one shared library with
a plain C interface, loaded with ctypes (pointers and the stream pass as
c_void_p; every entry point returns cudaGetLastError()). The library is
built at first use -- never when a module is imported -- into
llamole_tpu_torch/_build/ (listed in .gitignore), under a name hashed
from the sources and flags, so an edited source rebuilds and a built one
loads in milliseconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_attention.cu", "gin_aggregate.cu")
# -Xptxas -v makes ptxas report registers, shared memory and spills per
# kernel; the report is kept in KernelLibrary.build_log
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_library = None


class KernelLibrary:
    """The loaded kernels with their ctypes signatures declared."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("llamole_fused_attention_f32",
                     "llamole_fused_attention_bf16"):
            fn = getattr(self.cdll, name)
            # qkv, mask, q_scale, q_bias, k_scale, k_bias, out,
            # B, N, H, heads, stream
            fn.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
            fn.restype = i32
        for name in ("llamole_gin_aggregate_f32",
                     "llamole_gin_aggregate_bf16"):
            fn = getattr(self.cdll, name)
            # x, edge, adj, table, out, B, N, H, stream
            fn.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
            fn.restype = i32
        self.cdll.llamole_cuda_error_string.argtypes = [i32]
        self.cdll.llamole_cuda_error_string.restype = ctypes.c_char_p

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.cdll.llamole_cuda_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _build() -> KernelLibrary:
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        digest.update(s.read_bytes())
    out = BUILD_DIR / f"libllamole_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return KernelLibrary(out, 0.0, "(cached build)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-process temporary names + atomic rename: concurrent builders
    # never load a half-written library
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    nvcc = _nvcc()
    # one nvcc per source, all at once; then one link
    with ThreadPoolExecutor(len(srcs)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, "-c", "-o", str(so[1]),
                             str(so[0])]), zip(srcs, objs)))
    logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return KernelLibrary(out, seconds, "".join(logs))


def library() -> KernelLibrary:
    """The kernel library, built on the first call."""
    global _library
    with _lock:
        if _library is None:
            _library = _build()
        return _library
