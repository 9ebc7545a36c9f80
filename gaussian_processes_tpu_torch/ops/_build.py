"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  PyTorch's extension headers
are never included, so a build takes seconds, not minutes.  The library is
written to ``gaussian_processes_tpu_torch/_build/`` under a name keyed on a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  ``nvcc`` is looked up only when a kernel is first
needed: the package imports, and its plain PyTorch paths run, on a machine
without the CUDA toolkit.

Every entry point takes the CUDA device index first and the stream last and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on any
other value than 0 (``gp_product_splits`` launches nothing and returns a
count).  Each wrapper counts its launches in ``launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gaussian_processes_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: launches per kernel wrapper, incremented only where a kernel is launched;
#: the package's one counter, ``utils.profiling.counts``
launch_counts = profiling.counts

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # B1 and B4 take a tree's program (a host int array) after the family
    "gp_pairwise_k": (_I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P),
    "gp_pairwise_deriv": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gp_pairwise_k_chains": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P),
    "gp_pairwise_jac_chains": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gp_pairwise_jac_contract_chains": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gp_pairwise_jac_contract_blocks": (_I,),
    "gp_chol_tile": (_I, _P, _P, _I, _I, _P),
    "gp_chol_tile_inv": (_I, _P, _P, _P, _I, _I, _P),
    "gp_kernel_matvec": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P),
    "gp_kernel_jacvec": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gp_pairwise_ard": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P),
    "gp_ard_matvec": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}
#: entry points that do not depend on the element type and carry no suffix
_PLAIN_SIGNATURES = {
    "gp_product_splits": (_I, _I, _I, _I),
}


def sources() -> list:
    """The kernel sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every source's name and bytes and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of gaussian_processes_tpu_torch need the CUDA toolkit to build"
    )


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` unless an up-to-date build exists."""
    out = BUILD_DIR / f"libgp_kernels_{source_hash()}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, proc in procs:  # wait for every compile, then report
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        so = str(Path(tmp) / out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(so, out)  # atomic: a concurrent builder sees a whole file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    named = [(name + suffix, argtypes) for name, argtypes in _SIGNATURES.items()
             for suffix in ("_f32", "_f64")]
    for name, argtypes in named + list(_PLAIN_SIGNATURES.items()):
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def entry(name: str, dtype) -> ctypes._CFuncPtr:
    """The C entry point ``name`` for a torch float32 / float64 dtype."""
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: CUDA kernels take float32 or float64, got {dtype}")
    return getattr(library(), name + suffix)


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
