"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file compiles with its own nvcc, all started together,
and one more nvcc links the objects into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/yaik_tpu_torch/libyaik_kernels-<hash>.so <obj>/*.o

The library's name carries a hash of the sources, so an edited source
builds anew. The build links in a temp directory beside the library and
renames it into place, so a concurrent importer (pytest-xdist workers)
never loads a half-written library. A failed build raises with nvcc's
output. Each C entry point returns `cudaGetLastError()` after its launch;
`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "yaik_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
# C entry points: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    # corners, code4, shifts (host [14] i32), out, B, qh, qw, H, W, stream
    "yaik_grad_plane": (P, P, P, P, I, I, I, I, I, P),
    # corners, code4, shifts, vc, out, B, qh, qw, H, W, stream
    "yaik_grad_plane_final": (P, P, P, P, P, I, I, I, I, I, P),
    # tab, C, idx16, cols, accept, rows, G4, out, stream
    "yaik_t3_merged": (P, I, P, P, P, P, I, P, P),
    # tab, C, idx16, cols, accept, rows, prm, codes4, wm2, G4, ntx4, out,
    # stream
    "yaik_t3_merged_d1": (P, I, P, P, P, P, P, P, P, I, I, P, P),
    # tab, C, idx16, cols, chm, rows, G4, out, stream
    "yaik_t2_merged": (P, I, P, P, P, P, I, P, P),
    # tab, R, packed, cols, chm, rows, B, nty, ntx, sy, sx, H, W, out,
    # stream
    "yaik_lut_pass": (P, I, P, P, P, P, I, I, I, I, I, I, I, P, P),
    # c, alive, qpts, T, P, E, out, stream
    "yaik_score48": (P, P, P, L, I, I, P, P),
    # c, alive, qpts, T, P, E, mode48, stream
    "yaik_score48_mode": (P, P, P, L, I, I, P, P),
    # tiles, alive, a_c, b_c, mode48, mn, d, pts, factors, scratch, T, P,
    # E, accept, tile_type, idx, stream
    "yaik_values48": (P, P, P, P, P, P, P, P, P, P, L, I, I, P, P, P, P),
    # planes, claims, accepts, B, h, w, G, reject_factor, stream
    "yaik_grad_score": (P, P, P, I, I, I, L, I, P),
    # cands, tiles, k, n, gate, out, stream
    "yaik_covers": (P, P, I, I, I, P, P),
    # cands, cmask, tiles, tmask, starts, tfirst, scratch, k, n, nb, cap,
    # gate, out, stream
    "yaik_covers2d": (P, P, P, P, P, P, P, I, I, I, I, I, P, P),
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libyaik_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, str]:
    """Compile the sources unless the library for their hash exists.
    Returns (library path, nvcc's output with ptxas's per-kernel register
    and spill report; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(prefix=".build-", dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], None
        for cmd, proc in procs:       # wait for every one, so none outlives us
            log.append(proc.communicate()[0])
            if proc.returncode != 0 and failed is None:
                failed = (f"nvcc failed (rc={proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log[-1]}")
        if failed is not None:
            raise RuntimeError(failed)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stderr}")
        os.replace(lib, out)
    return out, "".join(log) + r.stdout + r.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per
    process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.yaik_error_string.argtypes = [ctypes.c_int]
    lib.yaik_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().yaik_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
