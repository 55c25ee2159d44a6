"""The encoder's gradient stage (`kernels.grad_score`, the counterpart of
`jax_scoring.gradient_all_device`) against the JAX package on the CPU.

The same cases for each (the fixtures img64 and quilt128; seeded images of
smooth ramps broken by noise pixels, so that every pass accepts tiles;
random initial claims; heights and widths with h % 16 == 8 and w % 16 ==
8; a band's 16k + 1 row slice; tiles that only round6p's clamp at 255
accepts; a batch of 3; reject factors -1, 255, 300 and 2^31 - 1, at and
past the ends of the wrapper's clamp to [-1, 255]):

- `scoring.gradient_all` on the CPU (the kernel's plain version, behind
  the wrapper's clamp) against `gradient_all_device`: every accept grid
  and the claims;
- a numpy model of the block algorithm (each 16x16 block alone, `ok` from
  the planes alone through the block's 5x5 corner lattice, then the 7
  passes resolved in order on a 16-bit mask of the block's 4x4 cells)
  against the same function;
- a numpy model of the CUDA kernel's arithmetic
  (yaik_tpu_torch/ops/csrc/grad_score.cu), every block at once: the clamp,
  a lane's column of 8 rows, the numerators stepped down it, the least and
  greatest x = num - ((p - rf) << 20) of its pixels range-checked for each
  blend, each test's ballot ANDed over the tile's lanes, the in-order
  resolution and the claims, against the same function.

A last test holds the range check to the blend test it replaces at every
boundary numerator, for every pixel value and reject factor -3..259.

Every comparison is exact, tolerance 0: the arithmetic is integer. The
kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from yaik_tpu.encoder import jax_scoring as js
from yaik_tpu.format import swizzle
from yaik_tpu_torch.encoder import batch, scoring
from yaik_tpu_torch.ops import kernels
from torch_streams import ramp_planes, saturated_planes

FIX = pathlib.Path(__file__).parent / "fixtures"
ORDER = swizzle.GRADIENT_PASS_ORDER
ROUNDING = (1 << 19) - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fixture(name):
    img = np.asarray(Image.open(FIX / f"{name}.png"))
    return img[:, :, :3].transpose(2, 0, 1).astype(np.int32)


def _smooth(h, w, seed):
    return ramp_planes(np.random.default_rng(seed), 1, h, w)[0]


def _claims(shape, seed, share=0.03):
    return np.random.default_rng(seed).random(shape) < share


def _case(name):
    """(planes [B, 3, h, w] i32, initial claims [B, 3, h, w] bool, reject
    factor, what the JAX function accepts: a tile in every pass ("every"),
    some tile ("some") or none ("none"))."""
    z = np.zeros
    if name in ("img64", "quilt128"):
        p = _fixture(name)
        return p[None], z((1,) + p.shape, bool), 3, "some"
    if name == "img64_rf10":
        p = _fixture("img64")
        return p[None], z((1,) + p.shape, bool), 10, "some"
    if name == "smooth96x80":
        p = _smooth(96, 80, 1)
        return p[None], z((1,) + p.shape, bool), 3, "every"
    if name == "smooth_claims":
        p = _smooth(96, 80, 2)
        return p[None], _claims((1,) + p.shape, 5), 3, "every"
    if name == "h8":                       # h % 16 == 8
        p = _smooth(88, 64, 3)
        return p[None], _claims((1,) + p.shape, 6), 3, "every"
    if name == "w8":                       # w % 16 == 8
        p = _smooth(64, 88, 4)
        return p[None], z((1,) + p.shape, bool), 3, "every"
    if name == "h8w8":
        p = _smooth(40, 56, 7)
        return p[None], _claims((1,) + p.shape, 8), 3, "some"
    if name == "halo":                     # a band of 48 rows + its halo row
        p = np.ascontiguousarray(_smooth(64, 64, 9)[:, :49])
        return p[None], z((1,) + p.shape, bool), 3, "every"
    if name == "img64_halo":
        p = np.ascontiguousarray(_fixture("img64")[:, :33])
        return p[None], z((1,) + p.shape, bool), 3, "some"
    if name == "saturated":
        p = saturated_planes(64, 64)
        return p[None], z((1,) + p.shape, bool), 0, "some"
    if name == "batch3":
        a = _fixture("img64")
        p = np.stack([a, np.ascontiguousarray(a[:, ::-1, ::-1]),
                      _smooth(64, 64, 10)])
        return p, _claims(p.shape, 11), 3, "some"
    if name.startswith("rf"):           # the reject factor's ends
        rf = int(name[2:].replace("m", "-"))
        p = _smooth(72, 88, 12)
        p[:, :32, :32] = 200               # tiles that reject factor 0 takes
        return (p[None], _claims((1,) + p.shape, 13), rf,
                "none" if rf < 0 else "some")
    raise KeyError(name)


CASES = ["img64", "quilt128", "img64_rf10", "smooth96x80", "smooth_claims",
         "h8", "w8", "h8w8", "halo", "img64_halo", "saturated", "batch3",
         "rfm1", "rf255", "rf300", f"rf{2 ** 31 - 1}"]


@functools.lru_cache(maxsize=None)
def _jax(case):
    """gradient_all_device of each image of `case` alone: (the 7 accept
    grids, each [B, nty, ntx], the claims [B, 3, h, w]); computed once per
    case, read only."""
    planes, claims, rf, _ = _case(case)
    per = [js.gradient_all_device(jnp.asarray(p), jnp.asarray(c), rf)
           for p, c in zip(planes, claims)]
    return ([np.stack([np.asarray(acc[k]) for acc, _ in per])
             for k in range(len(ORDER))],
            np.stack([np.asarray(c) for _, c in per]))


@pytest.mark.parametrize("case", CASES)
def test_gradient_all_matches_jax(case):
    """`scoring.gradient_all` on the CPU, one call for the batch: every
    accept grid and the claims equal `gradient_all_device` of each image
    alone."""
    planes, claims, rf, expect = _case(case)
    want, want_claims = _jax(case)
    got_claims = torch.from_numpy(claims.copy())
    got = scoring.gradient_all(torch.from_numpy(planes), got_claims, rf)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bool
        assert np.array_equal(g.numpy(), w), ORDER[k]
    assert np.array_equal(got_claims.numpy(), want_claims)
    if expect == "every":
        assert all(w.any() for w in want), [int(w.sum()) for w in want]
    assert any(w.any() for w in want) == (expect != "none")


def _round6(v):
    r = v >> 2
    return (r << 2) | (r >> 4)


def block_model(planes, claims, rf):
    """The kernel's algorithm for one image, block by block: planes
    [3, h, w] i32, claims [3, h, w] bool -> (the 7 accept grids, the
    claims after the stage)."""
    _, h, w = planes.shape
    accepts = [np.zeros((h >> sy, w >> sx), bool) for sx, sy in ORDER]
    out = claims.copy()
    for y0 in range(0, h, 16):
        for x0 in range(0, w, 16):
            # the block's 5x5 corner lattice, clamped, in three variants
            ys = np.minimum(y0 + 4 * np.arange(5), h - 1)
            xs = np.minimum(x0 + 4 * np.arange(5), w - 1)
            lat = planes[:, ys[:, None], xs[None, :]].astype(np.int64)
            corner = (lat, _round6(lat), _round6(np.minimum(lat + 1, 255)))
            claimed = 0        # cells claimed on entry, any channel
            for cell in range(16):
                y, x = y0 + 4 * (cell >> 2), x0 + 4 * (cell & 3)
                if y < h and x < w and claims[:, y, x].any():
                    claimed |= 1 << cell
            # ok: each tile's 6 blend bits, from the planes alone
            ok = []
            for sx, sy in ORDER:
                tw, th = 1 << sx, 1 << sy
                lf = 1024 - np.arange(tw)[None, None, :] * (1024 >> sx)
                tf = 1024 - np.arange(th)[None, :, None] * (1024 >> sy)
                tiles = {}
                for row in range(16 >> sy):
                    for col in range(16 >> sx):
                        ty, tx = (y0 >> sy) + row, (x0 >> sx) + col
                        if ty >= h >> sy or tx >= w >> sx:
                            continue
                        oy, ox = row * th, col * tw
                        pix = planes[:, y0 + oy:y0 + oy + th,
                                     x0 + ox:x0 + ox + tw]
                        r0, r1 = oy >> 2, (oy + th) >> 2
                        q0, q1 = ox >> 2, (ox + tw) >> 2
                        m = 0x3F
                        for v, cv in enumerate(corner):
                            a, b = cv[:, r0, q0, None, None], cv[:, r0, q1,
                                                                 None, None]
                            c, d = cv[:, r1, q0, None, None], cv[:, r1, q1,
                                                                 None, None]
                            num = ((a * lf + b * (1024 - lf)) * tf
                                   + (c * lf + d * (1024 - lf)) * (1024 - tf))
                            if not (abs(((num + ROUNDING) >> 20) - pix)
                                    <= rf).all():
                                m &= ~(1 << (2 * v))
                            if not (abs((num >> 20) - pix) <= rf).all():
                                m &= ~(2 << (2 * v))
                        tiles[row, col] = m
                ok.append(tiles)
            # the passes in order on the block's cells
            covered = 0
            for k, (sx, sy) in enumerate(ORDER):
                tw, th = 1 << sx, 1 << sy
                new = 0
                for (row, col), m in ok[k].items():
                    cr, cc = (row * th) >> 2, (col * tw) >> 2
                    acc = m != 0 and not (claimed >> (4 * cr + cc)) & 1
                    accepts[k][(y0 >> sy) + row, (x0 >> sx) + col] = acc
                    if acc:
                        for r in range(th >> 2):
                            new |= ((1 << (tw >> 2)) - 1) << (4 * (cr + r)
                                                              + cc)
                claimed |= new
                covered |= new
            for cell in range(16):
                if (covered >> cell) & 1:
                    y, x = y0 + 4 * (cell >> 2), x0 + 4 * (cell & 3)
                    out[:, y:y + 4, x:x + 4] = True
    return accepts, out


@pytest.mark.parametrize("case", CASES)
def test_block_model_matches_jax(case):
    """The numpy model of the kernel's block algorithm, image by image:
    every accept grid and the claims equal `gradient_all_device`'s."""
    planes, claims, rf, _ = _case(case)
    want, want_claims = _jax(case)
    for i in range(planes.shape[0]):
        got, got_claims = block_model(planes[i], claims[i], rf)
        for k, g in enumerate(got):
            assert np.array_equal(g, want[k][i]), (i, ORDER[k])
        assert np.array_equal(got_claims, want_claims[i]), i


def _i32(*arrays):
    """The kernel's int32 holds every value the model forms."""
    for a in arrays:
        assert np.all((a >= -2 ** 31) & (a < 2 ** 31))


def warp_model(planes, claims, rf):
    """The CUDA kernel's arithmetic for one image, every 16x16 block at
    once (int64 holding the kernel's int32 values): planes [3, h, w] i32,
    claims [3, h, w] bool -> (the 7 accept grids, the claims after the
    stage)."""
    rf = min(max(rf, -1), 255)                 # the wrapper's clamp
    span = 0 if rf < 0 else (2 * rf + 1) << 20
    _, h, w = planes.shape
    nby, nbx = -(-h // 16), -(-w // 16)
    # the block's corner lattice, clamped: [3 * variant + channel, by, bx,
    # row, col]
    ys = np.minimum(16 * np.arange(nby)[:, None] + 4 * np.arange(5), h - 1)
    xs = np.minimum(16 * np.arange(nbx)[:, None] + 4 * np.arange(5), w - 1)
    raw = planes[:, ys[:, None, :, None], xs[None, :, None, :]].astype(
        np.int64)
    lat = np.concatenate([raw, _round6(raw),
                          _round6(np.minimum(raw + 1, 255))])
    # lane l owns column l & 15 and rows 8 (l >> 4) .. + 7 of its block
    lane = np.arange(32)
    lx, hy = lane & 15, lane >> 4
    pad = np.zeros((3, nby * 16, nbx * 16), np.int64)
    pad[:, :h, :w] = planes
    blocks = pad.reshape(3, nby, 16, nbx, 16).transpose(0, 1, 3, 2, 4)
    pix = blocks[:, :, :, 8 * hy[:, None] + np.arange(8), lx[:, None]]
    nlo = (rf - pix) * (1 << 20)               # [3, by, bx, lane, row]
    # claims at the 16 cell origins, any channel, as the block's bit mask
    padc = np.zeros((3, nby * 16, nbx * 16), bool)
    padc[:, :h, :w] = claims
    cells = padc.reshape(3, nby, 16, nbx, 16).transpose(0, 1, 3, 2, 4)
    cell = np.arange(16)
    origin = cells[:, :, :, 4 * (cell >> 2), 4 * (cell & 3)].any(0)
    claimed = (origin.astype(np.int64) << cell).sum(-1)    # [by, bx]
    covered = np.zeros_like(claimed)
    by = np.arange(nby)[:, None, None]
    bx = np.arange(nbx)[None, :, None]
    accepts = []
    for sx, sy in ORDER:
        tw, th = 1 << sx, 1 << sy
        nseg = 2 if th == 4 else 1
        rows = 8 // nseg
        rep = {16: 0x1111, 8: 0x11, 4: 0x1}[th]
        ox = lx & ~(tw - 1)
        rw = (lx - ox) * (1024 >> sx)
        lf = 1024 - rw
        q0, q1 = ox >> 2, (ox + tw) >> 2
        cols = ((1 << tw) - 1) << ox
        lanes = cols | cols << 16 if th == 16 else cols << (16 * hy)
        grid = np.full((h >> sy, w >> sx), -1, np.int8)
        mine = np.zeros_like(claimed)
        for s in range(nseg):
            row0 = 8 * hy + rows * s
            tr = row0 >> sy
            r0 = (tr << sy) >> 2
            r1 = r0 + (th >> 2)
            ok = np.zeros((nby, nbx, 32), bool)
            for v in range(3):
                mn = np.full((nby, nbx, 32), 2 ** 31 - 1, np.int64)
                mx = np.full((nby, nbx, 32), -2 ** 31, np.int64)
                for c in range(3):
                    L = lat[3 * v + c]
                    top = L[:, :, r0, q0] * lf + L[:, :, r0, q1] * rw
                    bot = L[:, :, r1, q0] * lf + L[:, :, r1, q1] * rw
                    step = (bot - top) * (1024 >> sy)
                    num = top * 1024 + (8 * hy * step if th == 16 else 0)
                    # y(r) = r * step + nlo[r], stepped down the rows
                    y = [nlo[c, :, :, :, rows * s]]
                    for r in range(1, rows):
                        y.append(nlo[c, :, :, :, rows * s + r] + r * step)
                    y = np.stack(y, -1)
                    _i32(top, bot, step, num, y)
                    mn = np.minimum(mn, num + y.min(-1))
                    mx = np.maximum(mx, num + y.max(-1))
                    # every x the lane tests equals the JAX numerator's
                    iy = (row0 & (th - 1))[:, None] + np.arange(rows)
                    x = num[..., None] + y
                    want_num = (top[..., None] * (1024 - iy * (1024 >> sy))
                                + bot[..., None] * (iy * (1024 >> sy)))
                    assert np.array_equal(
                        x, want_num - (pix[c, :, :, :, rows * s:
                                             rows * (s + 1)] - rf) * 2 ** 20)
                _i32(mn, mx)
                for test in ((mn >= 0) & (mx < span),
                             (mn >= -ROUNDING) & (mx < span - ROUNDING)):
                    ballot = (test.astype(np.int64) << lane).sum(-1)
                    ok |= (ballot[..., None] & lanes) == lanes
            ty = ((16 * by) >> sy) + tr
            tx = ((16 * bx) >> sx) + (lx >> sx)
            valid = (tx < w >> sx) & (ty < h >> sy)
            acc = valid & ok & ((claimed[..., None] >> (4 * r0 + q0)) & 1
                                == 0)
            rect = ((((1 << (tw >> 2)) - 1) << q0) * rep) << (4 * r0)
            mine |= np.bitwise_or.reduce(np.where(acc, rect, 0), axis=-1)
            writer = valid & (lx == ox) & ((th < 16) | (hy == 0))
            ty, tx = np.broadcast_to(ty, acc.shape), np.broadcast_to(
                tx, acc.shape)
            grid[ty[writer], tx[writer]] = acc[writer]
        claimed |= mine
        covered |= mine
        assert (grid >= 0).all(), (sx, sy)    # every tile written once
        accepts.append(grid.astype(bool))
    pcell = 4 * (np.arange(16)[:, None] >> 2) + (np.arange(16) >> 2)
    cov = (covered[:, :, None, None] >> pcell) & 1     # [by, bx, row, col]
    full = cov.transpose(0, 2, 1, 3).reshape(nby * 16, nbx * 16)
    return accepts, claims | full[None, :h, :w].astype(bool)


@pytest.mark.parametrize("case", CASES)
def test_warp_model_matches_jax(case):
    """The numpy model of the CUDA kernel's arithmetic, image by image:
    every accept grid and the claims equal `gradient_all_device`'s."""
    planes, claims, rf, _ = _case(case)
    want, want_claims = _jax(case)
    for i in range(planes.shape[0]):
        got, got_claims = warp_model(planes[i], claims[i], rf)
        for k, g in enumerate(got):
            assert np.array_equal(g, want[k][i]), (i, ORDER[k])
        assert np.array_equal(got_claims, want_claims[i]), i


@pytest.mark.parametrize("rounding", [0, ROUNDING])
def test_range_check_is_the_blend_test(rounding):
    """For a numerator n in 0..255 * 2^20 (the planes hold 0..255), pixel
    p in 0..255 and any reject factor rf, |((n + rounding) >> 20) - p| <=
    rf holds exactly when x = n - ((p - rf') << 20) lies in [-rounding,
    span - rounding), rf' = rf clamped to [-1, 255], span = (2 rf' + 1) <<
    20 (0 for rf' = -1): at every boundary numerator (k * 2^20 - rounding
    and its neighbours), every p and rf in -3..259, 300 and 2^31 - 1."""
    k = np.arange(257)[:, None] << 20
    n = (k - rounding + np.array([-1, 0, 1])).ravel()
    n = np.unique(np.clip(np.concatenate([n, n + rounding]), 0, 255 << 20))
    p = np.arange(256)
    for rf in [*range(-3, 260), 300, 2 ** 31 - 1]:
        want = np.abs(((n[:, None] + rounding) >> 20) - p) <= rf
        rfc = min(max(rf, -1), 255)
        span = 0 if rfc < 0 else (2 * rfc + 1) << 20
        x = n[:, None] - (p - rfc) * (1 << 20)
        _i32(x)
        got = (x >= -rounding) & (x < span - rounding)
        assert np.array_equal(got, want), rf


@pytest.mark.parametrize("h,w", [(64, 64), (40, 56), (33, 88), (3, 200)])
def test_grad_score_packs_the_passes_in_order(h, w):
    """kernels.grad_score on the CPU: [B, G] u8 with G the blob's gradient
    prefix, its plain version's bytes, split into gradient_all's grids in
    GRADIENT_PASS_ORDER; one image [3, h, w] gives [G]."""
    planes = np.stack([_smooth(h, w, h + w), _smooth(h, w, h * w)])
    claims = _claims(planes.shape, 3)
    G = kernels.grad_score_len(h, w)
    assert G == batch._grad_packed_len(w, h)
    c1, c2 = torch.from_numpy(claims.copy()), torch.from_numpy(claims.copy())
    got = kernels.grad_score(torch.from_numpy(planes), c1, 3)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, G)
    assert torch.equal(got, kernels.grad_score_plain(
        torch.from_numpy(planes), c2, 3))
    assert torch.equal(c1, c2)
    c3 = torch.from_numpy(claims.copy())
    grids = scoring.gradient_all(torch.from_numpy(planes), c3, 3)
    assert torch.equal(torch.cat([g.reshape(2, -1) for g in grids], 1),
                       got.view(torch.bool))
    one = kernels.grad_score(torch.from_numpy(planes[1]),
                             torch.from_numpy(claims[1].copy()), 3)
    assert tuple(one.shape) == (G,) and torch.equal(one, got[1])


def test_grad_score_refuses_what_the_kernel_does_not_take():
    planes = torch.from_numpy(_smooth(32, 32, 1))
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.grad_score(planes.to(torch.int64), claims, 3)
    with pytest.raises(ValueError):
        kernels.grad_score(planes, claims[:, :16], 3)
    with pytest.raises(ValueError):
        kernels.grad_score(planes.transpose(1, 2), claims, 3)
    with pytest.raises(ValueError):
        kernels.grad_score(planes, claims, 2 ** 31)
    with pytest.raises(ValueError):
        kernels.grad_score(planes.to("meta"), claims.to("meta"), 3)
