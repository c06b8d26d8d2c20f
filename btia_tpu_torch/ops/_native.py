"""Build and load the port's CUDA kernels (``btia_tpu_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library with
a plain C interface, loaded through ``ctypes``. The library lives under
``btia_tpu_torch/_build/<hash>/``, where the hash covers the sources and the
compiler flags, so an edited source is rebuilt at its first use. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)
LIB_NAME = "libbtia_kernels.so"
H100_SMS = 132  # the H100's SMs: the persistent kernels' grids count blocks against them

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of plan values
_SIGNATURES = {
    "btia_layernorm": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    "btia_layernorm_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "btia_layernorm_bwd_parts": (_P, _P, _P, _P, _I, _I, _I),
    "btia_gemm_bias": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    "btia_attn_core": (_P, _P, _P, _P, _I, _P, _LLP, _IP, _I, _I, _I, _I, _I, _I, _P),
    "btia_attn_core_map_stats": (_LLP,),
    "btia_flash_bshd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "btia_fanout": (_P, _P, _P, _P, _P, _LLP, _IP, _I, _I, _I, _I, _I, _F, _P),
    "btia_mha_bhsd": (_P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I, _F, _I, _P),
    "btia_bicross": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LLP, _IP, _I, _I, _I, _I, _I, _F, _P),
    "btia_int8_quant_rows": (_P, _P, _P, _I, _I, _P),
    "btia_int8_gemm": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "btia_int8_dequant": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "btia_attn_simt": (_LLP, _I, _F, _F, _I, _I, _I, _IP, _P),
    "btia_attn_wide": (_LLP, _I, _F, _F, _I, _I, _I, _I, _I, _P),
    "btia_gemm_f32": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    "btia_moe_gemm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "btia_mla_attn": (_P, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from btia_tpu_torch/csrc at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless a
    library for the current sources already exists. Returns its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
            else:  # ptxas's registers / shared memory / spills per kernel, kept beside the library
                print(f"nvcc {src.name}:\n{log}", file=sys.stderr)
                (out_dir / f"{src.stem}.ptxas.txt").write_text(log)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(tmp_lib, lib_path)
    return lib_path


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def ptxas_log(source: str) -> str:
    """What nvcc (ptxas -v) said building `source` (a name in csrc, e.g.
    "attn_wide.cu") into the current library: "" if it was not built here."""
    p = BUILD_ROOT / source_hash() / f"{Path(source).stem}.ptxas.txt"
    return p.read_text() if p.exists() else ""


def timed_build() -> float:
    """Build (or find) and load the library; returns the seconds it took."""
    t0 = time.perf_counter()
    lib()
    return time.perf_counter() - t0


def route(entry, t: torch.Tensor, cuda_fn, plain_fn, *args):
    """Run a kernel entry by device: for a CUDA tensor `t`, launch the kernel
    through `cuda_fn(*args)` and count it in ``entry.launches``; for a CPU
    tensor, the plain PyTorch twin `plain_fn(*args)`. Nothing falls back."""
    if t.is_cuda:
        out = cuda_fn(*args)
        entry.launches += 1
        return out
    if t.device.type != "cpu":
        raise ValueError(f"{entry.__name__}: unsupported device {t.device}")
    return plain_fn(*args)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


# The current stream's handle as an int, without building a torch.cuda.Stream
# (a few microseconds a launch); absent from builds without CUDA.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t packed at a 16-byte aligned address, copied only where it is not:
    the kernels read rows in 16-byte vectors, and TMA needs the alignment."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def require(t: torch.Tensor, what: str, dtype=torch.bfloat16, contiguous: bool = True) -> None:
    """Raise unless t is a CUDA tensor of `dtype` (a dtype or a tuple of
    them), contiguous unless the kernel reads it through its strides."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if not t.is_cuda or t.dtype not in dtypes or (contiguous and not t.is_contiguous()):
        layout = "contiguous " if contiguous else ""
        raise ValueError(
            f"{what}: the CUDA kernel takes a {layout}{' or '.join(map(str, dtypes))} CUDA tensor, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
