"""Build the port's CUDA kernels into one shared library and load it.

The sources in the package's `csrc/*.cu` expose plain C functions. They are
compiled with `nvcc` for Hopper (`sm_90a`) into one `.so` under
`build/torch_kernels/` at the repository root, named by a hash of the sources
and flags, so a changed source builds anew and an unchanged one loads the
library already built. The library is loaded with `ctypes`; pointers and the
CUDA stream are passed as Python integers.

Nothing is built at import time: the first wrapper call on a CUDA tensor
builds. A missing `nvcc` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so the kernels round like the plain
# PyTorch versions they are checked against (see the notes in csrc/).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # img, ix, iy, out, dfx, dfy, n, c, h, w, reps, hg, wg, stream
    "warp_bilinear_nchw_f32": (_P,) * 6 + (_I,) * 7 + (_P,),
    # pred, target, out, m, c, h, w, reps, c1, c2, stream
    "reprojection_error_f32": (_P,) * 3 + (_I,) * 5 + (_F, _F, _P),
    # pred, target, g, dpred, m, c, h, w, reps, c1, c2, kssim, kl1, stream
    "reprojection_error_grad_f32": (_P,) * 4 + (_I,) * 5 + (_F,) * 4 + (_P,),
}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def library_path() -> Path:
    # the headers (*.cuh) that the sources include are hashed with them
    sources = sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libport_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    so = library_path()
    if not so.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC_DIR.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {err}")
