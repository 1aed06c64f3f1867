"""Build and load the port's hand-written Hopper kernels.

All CUDA sources under `neural_jacobian_field_torch/csrc/` are compiled by
`nvcc`, one process per source, all started together, and linked into ONE
shared library with a plain C interface, loaded through `ctypes` (no PyTorch
headers, so a build takes seconds, not minutes), against the CUDA driver
library (`-lcuda`: the K9 and K7 kernels encode TMA tensor maps). The
library is built at first use into `build/torch_kernels/` at the repository
root (listed in .gitignore), under a name that hashes the sources and flags,
so an edited source is rebuilt and concurrent processes never load a half-
written file (the library is compiled to a temporary name and renamed).

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no `nvcc` and no card.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported entry point: (argtypes, restype int = cudaError_t)
_SIGNATURES = {
    "njf_conv3x3_s1_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "njf_conv3x3_s1_fwd_stats": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P),
    "njf_conv3x3_s1_wgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "njf_pack2x2_fwd": (_P, _P, _I, _I, _I, ctypes.c_longlong, _P),
    "njf_pack2x2_bwd": (_P, _P, _I, _I, _I, _I, _I, _P),
    "njf_pdf_resample": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                         ctypes.c_float, _P),
    "njf_field_mlp_tz_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "njf_field_mlp_tz_fwd_wg": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "njf_field_mlp_tz_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    "njf_field_mlp_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _P),
    "njf_field_mlp_fwd_wg": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P),
    "njf_field_mlp_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "njf_field_mlp_bwd_wg": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    "njf_onehot_gather_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "njf_onehot_scatter_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    "njf_row_scatter": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    "njf_small_scatter": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "njf_upsample_bwd": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "njf_mark": (_P, _P),
    "njf_jt_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    "njf_jt_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I,
                   _P),
}


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: building "
                       "the port's CUDA kernels needs the CUDA toolkit")


def _link_flags(nvcc: str) -> list:
    """The driver API (cuTensorMapEncodeTiled, for the TMA tensor maps):
    -lcuda, with the toolkit's stub library on the search path where the
    driver's own libcuda.so is not."""
    root = Path(nvcc).resolve().parents[1]
    stubs = [d for d in (root / "lib64" / "stubs", root / "targets" / "x86_64-linux" / "lib" /
                         "stubs") if (d / "libcuda.so").exists()]
    return [f"-L{d}" for d in stubs[:1]] + ["-lcuda"]


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnjf_torch_kernels_{h.hexdigest()[:16]}.so"


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when a cached build was reused
        self.build_log = build_log

    def call(self, name: str, *args) -> None:
        """Call an entry point; raise if the launch was refused."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _compile(out: Path) -> str:
    """Compile every source to an object (one nvcc per source, in parallel),
    then link the shared library; returns the compilers' output."""
    nvcc = _find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        sources = [s for s in _sources() if s.suffix == ".cu"]
        objs = [Path(tmpdir) / f"{s.stem}.o" for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            text = proc.communicate()[0]
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = Path(tmpdir) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs), *_link_flags(nvcc)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


@functools.cache
def load_kernels() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        log = _compile(path)
        seconds = time.perf_counter() - t0
    elif path.with_suffix(".log").exists():
        log = path.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, path, seconds, log)


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on t's device, as an integer handle (the
    raw handle, without building a torch.cuda.Stream: ~0.1 against ~4 µs of
    host time per call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dispatch(name: str, t, cuda_fn, plain_fn):
    """A wrapper's device dispatch: cuda_fn() for a CUDA tensor t (it launches
    the kernel or raises), plain_fn() for a CPU tensor, an error elsewhere."""
    if t.device.type == "cuda":
        return cuda_fn()
    if t.device.type == "cpu":
        return plain_fn()
    raise ValueError(f"{name}: unsupported device {t.device}")


def check_cuda_tensor(t, name: str, dtype, ndim: int | None = None):
    """Validate what a kernel takes: CUDA, dtype, contiguous, 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
