"""Operands for the coverage matrices (`kernels.covers`, `covers2d`),
shared by tests/test_torch_mining.py (the plain version against the JAX
package on the CPU), tests/test_torch_cuda.py, chip_smoke.py and
tests/torch_time_covers.py (the kernels against the plain versions on the
card, and their times).

`corpus(k, n)` draws chip_smoke's corpus-scale operands of both kernels.
`point_sets(case, m, seed)` gives m point sets (each an [p, 2] i32 array,
p in 0..64) of one edge case; `operands(case, k, n, seed)` pads the
candidates (the first k sets of one draw) and the tiles (n sets) to 64
slots with their masks (`mining._padded`), and for "scatter" shuffles
each row's slots so that live and pad slots interleave, with arbitrary
values in the pad slots.
"""
import numpy as np

from yaik_tpu_torch.encoder.mining import _padded

# the cases, each a kind of point set the kernel must take exactly
CASES = ("seeded", "scatter", "empty_cands", "full_cands", "empty_tiles",
         "full_tiles", "tiny_tiles", "wide")
# gates: the miner's 36, none, a wide one, the largest int32, a negative
GATES = (36, 0, 2 ** 20, 2 ** 31 - 1, -1)


def corpus(k: int, n: int) -> dict:
    """Seeded clouds at the miner's corpus scale, by kernel name: 3D k
    candidates of 64 u8 points in the 64^3 cube and n tiles near them (so
    some are covered), 2D point sets of 1..64 points in the 64x64 plane
    (the first k the candidates), padded with their masks."""
    rng = np.random.default_rng(8)
    cands = rng.integers(0, 64, (k, 64, 3)).astype(np.uint8)
    near = cands[rng.integers(0, k, n)].astype(np.int32)
    tiles = np.clip(near + rng.integers(-6, 7, (n, 64, 3)), 0, 63)
    sets = [np.unique(rng.integers(0, 64, (int(m), 2)), axis=0)[:64]
            for m in rng.integers(1, 65, n)]
    return {"covers": (cands, tiles.astype(np.uint8)),
            "covers2d": (*_padded(sets[:k]), *_padded(sets))}


def _set(rng, p: int, span: int) -> np.ndarray:
    """A deduplicated set of at most p points in [0, span)^2."""
    if p == 0:
        return np.zeros((0, 2), np.int32)
    return np.unique(rng.integers(0, span, (p, 2)), axis=0)[:64].astype(
        np.int32)


def _full(rng, block: bool) -> np.ndarray:
    """64 distinct points: anywhere in the 64x64 plane, or an 8x8 block of
    it (a tile some candidates cover)."""
    if block:
        y, x = np.mgrid[:8, :8]
        o = rng.integers(0, 57, 2)
        return np.stack([x.ravel() + o[0], y.ravel() + o[1]], 1).astype(
            np.int32)
    flat = rng.choice(64 * 64, 64, replace=False)
    return np.stack([flat % 64, flat // 64], 1).astype(np.int32)


def point_sets(case: str, m: int, seed: int) -> list:
    """m point sets of `case`, drawn from `seed`: "seeded" (and "scatter")
    1..64 random points in the 64x64 plane, as chip_smoke's phase 2e;
    "empty_cands" / "empty_tiles" every third set empty (runs of empty
    sets included); "full_cands" every set 64 distinct points,
    "full_tiles" every set an 8x8 block; "tiny_tiles" 0..6 points each
    (dozens of tiles a batch of the kernel); "wide" sets in 0..4096 near
    a few centres (the kernel's int32 route), every fourth one in 0..63
    (its dp2a route beside it)."""
    rng = np.random.default_rng(seed)
    if case in ("seeded", "scatter"):
        return [_set(rng, int(rng.integers(1, 65)), 64) for _ in range(m)]
    if case.startswith("empty"):
        return [_set(rng, 0 if i % 3 == 0 or i % 7 == 1 else
                     int(rng.integers(1, 65)), 64) for i in range(m)]
    if case.startswith("full"):
        return [_full(rng, case == "full_tiles") for _ in range(m)]
    if case == "tiny_tiles":
        return [_set(rng, int(rng.integers(0, 7)), 64) for _ in range(m)]
    if case == "wide":
        centres = rng.integers(0, 4097 - 64, (4, 2))
        out = []
        for i in range(m):
            s = _set(rng, int(rng.integers(1, 65)), 64)
            out.append(s if i % 4 == 3 else
                       np.minimum(s + centres[i % 4], 4096).astype(
                           np.int32))
        out[0][:1] = 4096          # the largest coordinate the kernel takes
        return out
    raise ValueError(f"unknown case {case!r}")


def operands(case: str, k: int, n: int, seed: int) -> tuple:
    """(cands [k, 64, 2] i32, cand_mask [k, 64] bool, tiles [n, 64, 2] i32,
    tile_mask [n, 64] bool) of `case`: the candidates are the "seeded"
    draw's sets but for the *_cands cases, the tiles the case's sets."""
    cand_case = case if case.endswith("_cands") or case == "wide" else \
        "seeded"
    tile_case = "seeded" if case.endswith("_cands") else case
    cands = point_sets(cand_case, k, seed)
    tiles = point_sets(tile_case, n, seed + 1)
    if case == "wide":                  # tiles near the candidates' points
        rng = np.random.default_rng(seed + 2)
        for i in range(0, n, 2):
            c = cands[i % k]
            if len(c):
                tiles[i] = np.clip(c + rng.integers(-4, 5, c.shape), 0,
                                   4096).astype(np.int32)
    ops = [*_padded(cands), *_padded(tiles)]
    if case == "scatter":
        rng = np.random.default_rng(seed + 3)
        for i in (0, 2):
            perm = np.argsort(rng.random(ops[i + 1].shape), axis=1)
            ops[i] = np.take_along_axis(ops[i], perm[..., None], 1)
            ops[i + 1] = np.take_along_axis(ops[i + 1], perm, 1)
            junk = rng.integers(0, 4097, ops[i].shape, dtype=np.int32)
            ops[i] = np.where(ops[i + 1][..., None], ops[i], junk)
    return tuple(ops)


def sets_of(arr: np.ndarray, msk: np.ndarray) -> list:
    """The point sets of padded operands (each row's live slots in order),
    as the JAX package's `_covers2d_device` takes them."""
    return [a[m] for a, m in zip(arr, msk)]


def shares(cmask: np.ndarray, tmask: np.ndarray) -> tuple:
    """(live-point share of the candidates' slots, counted-pixel share of
    the tiles' slots)."""
    return float(np.mean(cmask)), float(np.mean(tmask))
