"""Build and load the port's CUDA kernels (one shared library, via ctypes).

The sources in `repro_torch/csrc/` are compiled with `nvcc` for Hopper
(`sm_90a`) at first use, one `nvcc` process per source started together,
then linked into one `.so` under `build/kernels/` at the repository root.
The library's name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached build. A failed
build raises with `nvcc`'s stderr. `ptxas`'s resource report (registers,
stack frame, spill stores and loads per kernel) is kept beside the
library and read by `resource_usage()`; `sass_counts()` counts each
kernel's tensor-core and asynchronous-copy instructions in the built
machine code. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("prox_sgd.cu", "fedagg.cu", "flash_attention.cu", "wkv6.cu",
           "flash_attention_bwd.cu", "wkv6_bwd.cu", "ssd.cu", "ssd_bwd.cu")
# Included by the sources: hashed with them, so an edit rebuilds.
HEADERS = ("wgmma.cuh", "ssd.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_vp, _i32, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
# (name, argtypes) of every C entry point; each returns cudaGetLastError().
_SIGNATURES = {
    # w, g, w0, w0_stride, steps, step, C, P, lr, mu, device, stream
    "prox_sgd_f32": [_vp, _vp, _vp, _i64, _vp, _i32, _i32, _i64, _f32, _f32,
                     _i32, _vp],
    "prox_sgd_bf16": [_vp, _vp, _vp, _i64, _vp, _i32, _i32, _i64, _f32, _f32,
                      _i32, _vp],
    # w, g, w0, group, mu_rows, steps, step, R, P, lr, mu, device, stream
    "prox_sgd_rows_f32": [_vp, _vp, _vp, _i64, _vp, _vp, _i32, _i32, _i64,
                          _f32, _f32, _i32, _vp],
    "prox_sgd_rows_bf16": [_vp, _vp, _vp, _i64, _vp, _vp, _i32, _i32, _i64,
                           _f32, _f32, _i32, _vp],
    # x, w, base, scale, partial, out, K, P, device, stream
    "fedagg_f32": [_vp, _vp, _vp, _f32, _i32, _vp, _i32, _i64, _i32, _vp],
    "fedagg_bf16": [_vp, _vp, _vp, _f32, _i32, _vp, _i32, _i64, _i32, _vp],
    # x, w, base, scale (S,), out, S, K, P, device, stream
    "fedagg_batched_f32": [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i64, _i32,
                           _vp],
    "fedagg_batched_bf16": [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i64, _i32,
                            _vp],
    # q, k, v, o, lse (or null), strides[4][3] (b, h, s of q, k, v, o), B,
    # H, KV, S, Sk, D, Dv, scale, causal, window (0 = none), softcap (0 =
    # none), device, stream
    "flash_attention_f32": [_vp] * 5 + [_i64p] + [_i32] * 7 + [
        _f32, _i32, _i32, _f32, _i32, _vp],
    "flash_attention_bf16": [_vp] * 5 + [_i64p] + [_i32] * 7 + [
        _f32, _i32, _i32, _f32, _i32, _vp],
    # r, k, v, logw, s0, o, s_final, strides[7][4], B, H, T, K, V, chunk,
    # states, flags, device, stream
    "wkv6_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64p, _i32, _i32, _i32,
                 _i32, _i32, _i32, _vp, _vp, _i32, _vp],
    "wkv6_generic_f32": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64p, _i32,
                         _i32, _i32, _i32, _i32, _i32, _vp, _vp, _i32, _vp],
    # q, k, v, o, dO, lse, dQ, dK, dV, delta, strides[8][3] (b, h, s), B,
    # H, KV, S, Sk, D, Dv, scale, causal, window, softcap, device, stream
    "flash_attention_bwd_f32": [_vp] * 10 + [_i64p] + [_i32] * 7 + [
        _f32, _i32, _i32, _f32, _i32, _vp],
    "flash_attention_bwd_bf16": [_vp] * 10 + [_i64p] + [_i32] * 7 + [
        _f32, _i32, _i32, _f32, _i32, _vp],
    # r, k, v, logw, s0, dO, dS_T (or null), dr, dk, dv, dlogw, ds0,
    # states, xfer, flags, strides[7][4], B, H, T, K, V, chunk, device,
    # stream
    "wkv6_bwd_f32": [_vp] * 15 + [_i64p, _i32, _i32, _i32, _i32, _i32, _i32,
                                  _i32, _vp],
    # xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, tail (or null),
    # weight strides[6], xh, r, v, k, dt, logw, G, B, T, E, H, device,
    # stream
    **{f"ssd_front_{t}": [_vp] * 9 + [_i64p] + [_vp] * 6 + [_i32] * 6
       + [_vp] for t in ("f32", "bf16")},
    # o, xh, xz, bt, ct, dt, d_skip, out_norm, weight strides[6], y, rstd,
    # G, B, T, E, H, device, stream
    **{f"ssd_back_{t}": [_vp] * 8 + [_i64p] + [_vp] * 2 + [_i32] * 6
       + [_vp] for t in ("f32", "bf16")},
    # dy, o, xh, xz, bt, ct, dt, d_skip, out_norm, weight strides[6], rstd,
    # du, dxz, p2, norm_part, G, B, T, E, H, device, stream
    **{f"ssd_back_bwd_{t}": [_vp] * 9 + [_i64p] + [_vp] * 5 + [_i32] * 6
       + [_vp] for t in ("f32", "bf16")},
    # du, dv, dr, dk, dlogw, p2, xz, tail, dt_raw, bt, ct, conv_w, conv_b,
    # dt_b, a_log, d_skip, weight strides[6], dt, logw, norm_part, dxz,
    # ddt_raw, dbt, dct, dtail, dconv_w, dconv_b, ddt_b, da_log, dd_skip,
    # dout_norm, conv_part, head_part, G, B, T, E, H, device, stream
    **{f"ssd_front_bwd_{t}": [_vp] * 16 + [_i64p] + [_vp] * 16 + [_i32] * 6
       + [_vp] for t in ("f32", "bf16")},
}


def find_nvcc() -> str:
    """`nvcc` from CUDA_HOME / CUDA_PATH, PATH, or /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc] + FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run commands concurrently; raise with the stderr of any failure,
    else return their output (stdout, then stderr) in command order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failures, logs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return "".join(logs)


def build() -> Path:
    """Compile the sources (if the cached build is stale) and return the
    path of the shared library."""
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"libreprokernels-{_digest(nvcc)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    log = _run_all([[nvcc, *FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                    for s, o in zip(SOURCES, objs)])
    log_tmp = lib.with_suffix(f".ptxas.{tag}.tmp")
    log_tmp.write_text(log)
    os.replace(log_tmp, lib.with_suffix(".ptxas.txt"))
    tmp = lib.with_suffix(f".{tag}.tmp")
    _run_all([[nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib)      # atomic: a concurrent loader sees all or none
    for o in objs:
        o.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, then cached)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.cache
def entry(name: str):
    """The C entry point `name` of the loaded library, looked up once: the
    wrappers call it on every launch."""
    return getattr(library(), name)


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names: list[str]) -> list[str]:
    """C++ names from `cu++filt` beside nvcc, or the mangled ones."""
    filt = Path(find_nvcc()).with_name("cu++filt")
    if not filt.exists():
        return names
    out = subprocess.run([str(filt), *names], capture_output=True, text=True,
                         timeout=60)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) \
        else names


def resource_usage() -> list[dict]:
    """Per kernel of the built library, from `ptxas -v`: registers per
    thread, stack frame and spill store/load bytes."""
    rows: list[dict] = []
    for line in build().with_suffix(".ptxas.txt").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            rows.append(dict(kernel=m.group(1)))
        elif rows and (m := _FRAME.search(line)):
            rows[-1].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        elif rows and (m := _REGS.search(line)):
            rows[-1]["registers"] = int(m.group(1))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


# SASS opcodes of the tensor cores and of asynchronous global-to-shared
# copies (TMA and cp.async).
TENSOR_CORE_OPS = ("HGMMA", "HMMA")
ASYNC_COPY_OPS = ("UTMALDG", "LDGSTS")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)")


def parse_sass(text: str) -> list[dict]:
    """Per kernel of a `cuobjdump -sass` listing: the count of
    tensor-core instructions and of asynchronous copies (mangled names)."""
    rows: list[dict] = []
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            rows.append(dict(kernel=m.group(1), tensor_core_ops=0,
                             async_copy_ops=0))
        elif rows and (m := _INSTRUCTION.search(line)):
            if m.group(1) in TENSOR_CORE_OPS:
                rows[-1]["tensor_core_ops"] += 1
            elif m.group(1) in ASYNC_COPY_OPS:
                rows[-1]["async_copy_ops"] += 1
    return rows


def sass_counts() -> list[dict]:
    """`parse_sass` of the built library, read with `cuobjdump` beside
    nvcc, with C++ names."""
    dump = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(dump), "-sass", str(build())],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    rows = parse_sass(out)
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
