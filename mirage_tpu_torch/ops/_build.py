"""Builds the sources under ``mirage_tpu_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` becomes ``build/mirage_tpu_torch/lib<name>.so`` with
a plain C interface, compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and loaded with ``ctypes``. The host library
``csrc/fastops.cpp`` (the data loader's resizes and warps) is compiled by
the host's C++ compiler instead (:func:`build_host`), so it builds on a
machine without ``nvcc``. Each build runs at first use and again whenever a
source is newer than its library. A failed build raises; there is no
fallback.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mirage_tpu_torch"
# native/Makefile's CXXFLAGS, so the port's host library gives the JAX
# package's bits
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = ("layernorm", "gemm", "gemm_stash", "attention", "attention_bwd",
           "flash_attention", "wgrad", "adamw", "fused_block", "quant",
           "gemm_lnfold", "attention_phased", "mlp_chunked", "mlp_bwd",
           "relpos_attention")
# C entry points: name -> (source, symbol, argtypes). Every entry returns
# a CUDA error code (0: launched).
ENTRIES = {
    "layernorm": ("layernorm", "mtt_layernorm",
                  [_P, _P, _P, _P] + [_I] * 6 + [_F, _P]),
    "layernorm_onepass": ("layernorm", "mtt_layernorm_onepass",
                          [_P, _P, _P, _P] + [_I] * 6 + [_F, _P]),
    "layernorm_bwd": ("layernorm", "mtt_layernorm_bwd",
                      [_P] * 9 + [_I] * 7 + [_F, _P]),
    "gemm": ("gemm", "mtt_gemm", [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                                  _I, _P, _P, _P]),
    "gemm_kn": ("gemm", "mtt_gemm_kn", [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                        _I, _I, _P, _P, _P]),
    "gemm_gelu_mode": ("gemm", "mtt_gemm_gelu_mode",
                       [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]),
    "gemm_stash": ("gemm_stash", "mtt_gemm_stash",
                   [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "attention": ("attention", "mtt_attention",
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _I, _LL, _I, _LL,
                   _I, _LL, _I, _F, _I, _P]),
    "attention_bwd": ("attention_bwd", "mtt_attention_bwd",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    "flash_fwd": ("flash_attention", "mtt_flash_fwd",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "flash_bwd": ("flash_attention", "mtt_flash_bwd",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                   _I, _P]),
    "wgrad": ("wgrad", "mtt_wgrad", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "colsum": ("wgrad", "mtt_colsum", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "adamw_tiles": ("adamw", "mtt_adamw_tiles",
                    [_P, _I, _LL, _P, _P, _I, _P] + [_F] * 5 + [_P]),
    "adamw_norm": ("adamw", "mtt_adamw_norm",
                   [_P, _I, _LL] + [_P] * 9 + [_I] + [_F] * 4 + [_P]),
    "fused_block": ("fused_block", "mtt_fused_block",
                    [_P] * 19 + [_I] * 9 + [_F, _F, _I, _P, _P]),
    "fused_block_occupancy": ("fused_block", "mtt_fused_block_occupancy",
                              [_I, _I, _I, _P]),
    "ln_quant": ("quant", "mtt_ln_quant", [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P]),
    "quant_rows": ("quant", "mtt_quant_rows", [_P, _P, _P, _P, _I, _I, _P]),
    "gemm_s8": ("quant", "mtt_gemm_s8",
                [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "gemm_lnfold": ("gemm_lnfold", "mtt_gemm_lnfold",
                    [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F,
                     _P]),
    "attention_phased": ("attention_phased", "mtt_attention_phased",
                         [_P] * 4 + [_I] * 10 + [_LL, _I] * 4
                         + [_F, _I, _I, _P]),
    "mlp_chunked": ("mlp_chunked", "mtt_mlp_chunked",
                    [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]),
    "mlp_bwd_hidden": ("mlp_bwd", "mtt_mlp_bwd_hidden",
                       [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_P]),
    "mlp_bwd_dyln": ("mlp_bwd", "mtt_mlp_bwd_dyln",
                     [_P] * 3 + [_I] * 6 + [_P]),
    "relpos_attn": ("relpos_attention", "mtt_relpos_attn",
                    [_P] * 6 + [_I] * 7 + [_F, _P]),
    # the task-strided forms (one launch over a stack of T tasks' weights)
    "layernorm_tasks": ("layernorm", "mtt_layernorm_tasks",
                        [_P, _P, _P, _P] + [_I] * 7 + [_F, _P]),
    "layernorm_bwd_tasks": ("layernorm", "mtt_layernorm_bwd_tasks",
                            [_P] * 9 + [_I] * 8 + [_F, _P]),
    "gemm_tasks": ("gemm", "mtt_gemm_tasks",
                   [_P, _P, _P, _P, _I, _P] + [_I] * 7 + [_P]),
    "mlp_bwd_hidden_tasks": ("mlp_bwd", "mtt_mlp_bwd_hidden_tasks",
                             [_P] * 4 + [_I] + [_P] * 4 + [_I] * 6 + [_P]),
    "mlp_bwd_dyln_tasks": ("mlp_bwd", "mtt_mlp_bwd_dyln_tasks",
                           [_P] * 3 + [_I] * 7 + [_P]),
    "wgrad_tasks": ("wgrad", "mtt_wgrad_tasks", [_P] * 4 + [_I] * 7 + [_P]),
    "colsum_tasks": ("wgrad", "mtt_colsum_tasks", [_P] * 3 + [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_funcs = {}
ptxas_report = {}  # source name -> nvcc's register / shared-memory report


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(force: bool = False) -> dict:
    """Compiles every stale source in parallel; returns ptxas_report."""
    with _lock:
        todo = [n for n in SOURCES if force or _stale(n)]
        if not todo:
            return ptxas_report
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = {}
        for name in todo:
            out = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
            procs[name] = (out, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            ptxas_report[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            else:
                os.replace(out, BUILD_DIR / f"lib{name}.so")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return ptxas_report


def entry(name: str):
    """The ctypes function of one source's C entry point, built on demand."""
    fn = _funcs.get(name)
    if fn is not None:
        return fn
    build()
    with _lock:
        if name not in _funcs:
            source, symbol, argtypes = ENTRIES[name]
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{source}.so"))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return _funcs[name]


def host_compiler() -> str:
    """``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def build_host(build_dir: Path = BUILD_DIR, force: bool = False) -> Path:
    """``csrc/fastops.cpp`` compiled by :func:`host_compiler` with
    HOST_FLAGS into ``build_dir/libfastops.so`` where that library is
    missing or older than its source (always with ``force``); never calls
    nvcc. Returns the library's path.

    Safe under several processes and threads: a lock file
    (``fcntl.flock``) serialises the compile across processes, the
    compiler writes ``libfastops.so.tmp<pid>`` and ``os.replace`` moves it
    into place, so no process loads a half-written library. A compiler
    that cannot run or fails raises RuntimeError with its output."""
    src = CSRC / "fastops.cpp"
    lib = Path(build_dir) / "libfastops.so"

    def fresh():
        return (not force and lib.exists()
                and lib.stat().st_mtime >= src.stat().st_mtime)

    with _lock:
        if fresh():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        with open(lib.parent / "libfastops.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if fresh():  # another process built it while we waited
                    return lib
                tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
                cmd = [host_compiler(), *HOST_FLAGS, "-shared", "-o",
                       str(tmp), str(src)]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True, timeout=600)
                except OSError as e:
                    raise RuntimeError(f"{' '.join(cmd)}: the host compiler "
                                       f"could not run: {e}") from e
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib)
                return lib
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
