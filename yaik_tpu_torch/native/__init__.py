"""ctypes binding for the port's native host runtime (`yaik_host.cpp`, the
port's copy of `yaik_tpu/native/yaik_host.cpp`).

The library builds at first use, not at import:

    g++ -O3 -fPIC -shared -o build/yaik_tpu_torch/libyaik_host-<hash>.so \\
        yaik_tpu_torch/native/yaik_host.cpp

The name carries a hash of the source and flags, so an edited source builds
anew. One process builds while the others wait on a file lock (pytest-xdist
workers start together); it compiles into a temp directory beside the
library and renames it into place, so no process ever loads a half-written
file. Without g++, or when the build fails, `available()` is False and the
callers take their pure-Python twins (identical output, slower); the
failure is printed once to stderr. `build_shared` also builds the C-ABI
decoder library (`capi.py`) the same way.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "yaik_host.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "yaik_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry points: name -> (restype, argtypes)
SIGNATURES = {
    "palette_decompress": (I, (ctypes.c_char_p, I, P, I, I)),
    "palette_compress": (I, (ctypes.c_char_p, I, P, I, P, P)),
    "dyn1d_plane": (I, (P, P, I, I, I, I, P, P, P)),
    "emit_gtil_pass": (L, (P, I, I, I, I, I, I, P, P, P, P, P, P, P)),
    "plan_3d_all": (None, (P, P, I, I, P, L, P, L, P, L, P, L, P, L, P, L,
                           P, L, P, P, P, P, P)),
    "plan_1d_all": (None, (I, I, P, L, L, P, L, P, L, L, P, P, P)),
    "plan_gtil_full": (None, (P, L, I, I, I, I, I, I, P, L, P, P, L, P, L, L,
                              P)),
}


def shared_library_path(stem: str, inputs, flags) -> pathlib.Path:
    """build/yaik_tpu_torch/<stem>-<hash>.so, the hash of the input files'
    bytes and the flags."""
    h = hashlib.sha256()
    for path in inputs:
        h.update(pathlib.Path(path).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_shared(stem: str, sources, flags, libs=(), depends=()
                 ) -> pathlib.Path:
    """Compile `sources` with g++ into a shared library unless it exists
    (its name hashes the sources, the files in `depends` and the flags);
    raises with g++'s message on a failed build."""
    out = shared_library_path(stem, [*sources, *depends], [*flags, *libs])
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if out.exists():                     # another process built it
            return out
        with tempfile.TemporaryDirectory(prefix=f".{stem}-",
                                         dir=BUILD_DIR) as tmp:
            lib = os.path.join(tmp, "lib.so")
            cmd = ["g++", *flags, "-o", lib, *map(str, sources), *libs]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed "
                                   f"(rc={r.returncode}):\n{r.stderr}")
            os.replace(lib, out)
    return out


def library_path() -> pathlib.Path:
    return shared_library_path("libyaik_host", [SOURCE], CXX_FLAGS)


def build() -> pathlib.Path:
    """Compile the library unless it exists; raises on a failed build."""
    return build_shared("libyaik_host", [SOURCE], CXX_FLAGS)


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (once per process)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        print(f"yaik_tpu_torch: host library unavailable ({e}); pure-Python "
              "fallbacks in effect", file=sys.stderr)
        return None
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
    return lib


def available() -> bool:
    return library() is not None


def palette_decompress(data: bytes, output_size: int,
                       color_compression: int) -> np.ndarray:
    out = np.zeros(output_size, np.uint8)
    r = library().palette_decompress(data, len(data), out.ctypes.data,
                                     output_size, color_compression)
    if r < 0:
        raise ValueError("palette stream invalid")
    return out


class NativePaletteState:
    """Persistent CodeRGB state (encoder.palette_codec.PaletteState)."""

    def __init__(self):
        self.entries = np.zeros(4096 * 3, np.int32)
        self.length = np.zeros(1, np.int32)


def palette_compress(data: bytes, state: NativePaletteState) -> bytes | None:
    out = np.empty(max(len(data) * 3, 1024), np.uint8)
    r = library().palette_compress(
        data, len(data), out.ctypes.data, len(out),
        state.entries.ctypes.data, state.length.ctypes.data)
    if r < 0 or r >= len(data) * 3:
        return None
    return out[:r].tobytes()


def dyn1d_plane(plane: np.ndarray, claim: np.ndarray,
                color_compression: int, range_compression: int):
    h, w = plane.shape
    p8 = np.ascontiguousarray(plane, np.uint8)
    c8 = np.ascontiguousarray(claim, np.uint8)
    pix = np.empty(w * h, np.uint8)
    typ = np.empty((w // 8) * (h // 8) * 3, np.uint8)
    tlen = np.zeros(1, np.int32)
    plen = library().dyn1d_plane(p8.ctypes.data, c8.ctypes.data, w, h,
                                 color_compression, range_compression,
                                 pix.ctypes.data, typ.ctypes.data,
                                 tlen.ctypes.data)
    return pix[:plen].tobytes(), typ[:int(tlen[0])].tobytes()


def _vp(a):
    # raw pointer int: from_buffer + addressof is ~1 us against ~3 us for
    # a.ctypes.data (a fresh interface object per call); read-only buffers
    # fall back
    try:
        return ctypes.addressof(ctypes.c_char.from_buffer(a))
    except (TypeError, ValueError, BufferError):
        return a.ctypes.data


def emit_gtil_pass(accept_u8, w, h, sx, sy, bx, by, corner_bytes,
                   mapped4, claims4, bitmap_out, rgb_out):
    """One full-plane gradient pass emission (see gradient.emit_pass):
    swizzle-scan bitmap + corner-dedup byte stream + claims4 footprint,
    all in one native call. accept_u8 is the C-contiguous u8 grid
    [ceil(h / th), ceil(w / tw)] the library indexes, else ValueError.
    Returns (tile_count, rgb_byte_count, (min_tx, min_ty, max_tx,
    max_ty))."""
    grid = (-(-h >> sy), -(-w >> sx))
    if (not isinstance(accept_u8, np.ndarray) or accept_u8.dtype != np.uint8
            or accept_u8.shape != grid
            or not accept_u8.flags.c_contiguous):
        raise ValueError(f"accept_u8 must be a C-contiguous uint8 array of "
                         f"shape {grid}")
    n = np.zeros(1, np.int64)
    bb = np.zeros(4, np.int32)
    cnt = library().emit_gtil_pass(
        _vp(accept_u8), w, h, sx, sy, bx, by, _vp(corner_bytes),
        _vp(mapped4), _vp(claims4) if claims4 is not None else None,
        _vp(bitmap_out), _vp(rgb_out), n.ctypes.data, bb.ctypes.data)
    return int(cnt), int(n[0]), bb


def plan_1d_all(w, h, claims, plane_stride, types_u8, pix, inv_range,
                params, indices, wmask) -> None:
    """All three 1D residual planes in one call (see planner._plan_1d).
    plane_stride: bytes between per-plane claim grids (0 = shared)."""
    library().plan_1d_all(w, h, _vp(claims), plane_stride, claims.shape[-1],
                          _vp(types_u8), types_u8.size, _vp(pix), pix.size,
                          inv_range, _vp(params), _vp(indices), _vp(wmask))


def plan_3d_all(bitmaps, w, h, types_u16, colors_i32, claims, streams,
                cursors, accept_all, type_all, cols_all, packed_all) -> None:
    """All six 3D size passes in one native call (see planner._plan_3d):
    bitmaps is a 6-list of u8 arrays (empty -> pass skipped); outputs land
    in the contiguous arenas at canonical TILE3D_PASS_ORDER offsets."""
    ptrs = np.array([_vp(b) if b.size else 0 for b in bitmaps], np.int64)
    lens = np.array([b.size for b in bitmaps], np.int64)
    s3, s4, s5, s6 = streams
    library().plan_3d_all(
        _vp(ptrs), _vp(lens), w, h,
        _vp(types_u16), types_u16.size, _vp(colors_i32),
        colors_i32.shape[0], _vp(claims), claims.shape[1],
        _vp(s3), s3.size, _vp(s4), s4.size, _vp(s5), s5.size,
        _vp(s6), s6.size, _vp(cursors), _vp(accept_all), _vp(type_all),
        _vp(cols_all), _vp(packed_all))


def plan_gtil_full(bitmap, w, h, sx, sy, bx, by, rgb3, map_rgb, has_rgb,
                   stride_q, claims, accept) -> None:
    """One full GTIL (plane==7) pass: bitmap walk + corner first-touch
    dedup + quad claims + accept grid (see planner.build_plan)."""
    library().plan_gtil_full(_vp(bitmap), bitmap.size, w, h, sx, sy, bx, by,
                             _vp(rgb3), rgb3.size, _vp(map_rgb),
                             _vp(has_rgb), stride_q, _vp(claims),
                             claims.shape[0], claims.shape[1], _vp(accept))
