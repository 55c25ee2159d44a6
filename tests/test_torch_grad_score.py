"""The encoder's gradient stage (`kernels.grad_score`, the counterpart of
`jax_scoring.gradient_all_device`) against the JAX package on the CPU.

Two tests, the same cases each (the fixtures img64 and quilt128; seeded
images of smooth ramps broken by noise pixels, so that every pass accepts
tiles; random initial claims; heights and widths with h % 16 == 8 and
w % 16 == 8; a band's 16k + 1 row slice; tiles that only round6p's clamp
at 255 accepts; a batch of 3):

- `scoring.gradient_all` on the CPU (the kernel's plain version) against
  `gradient_all_device`: every accept grid and the claims;
- a numpy model of the CUDA kernel's block algorithm
  (yaik_tpu_torch/ops/csrc/grad_score.cu) against the same function: each
  16x16 block alone, `ok` from the planes alone through the block's 5x5
  corner lattice, then the 7 passes resolved in order on a 16-bit mask of
  the block's 4x4 cells.

Every comparison is exact, tolerance 0: the arithmetic is integer. The
kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py.
"""
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
    factor, whether every pass must accept a tile)."""
    z = np.zeros
    if name in ("img64", "quilt128"):
        p = _fixture(name)
        return p[None], z((1,) + p.shape, bool), 3, False
    if name == "img64_rf10":
        p = _fixture("img64")
        return p[None], z((1,) + p.shape, bool), 10, False
    if name == "smooth96x80":
        p = _smooth(96, 80, 1)
        return p[None], z((1,) + p.shape, bool), 3, True
    if name == "smooth_claims":
        p = _smooth(96, 80, 2)
        return p[None], _claims((1,) + p.shape, 5), 3, True
    if name == "h8":                       # h % 16 == 8
        p = _smooth(88, 64, 3)
        return p[None], _claims((1,) + p.shape, 6), 3, True
    if name == "w8":                       # w % 16 == 8
        p = _smooth(64, 88, 4)
        return p[None], z((1,) + p.shape, bool), 3, True
    if name == "h8w8":
        p = _smooth(40, 56, 7)
        return p[None], _claims((1,) + p.shape, 8), 3, False
    if name == "halo":                     # a band of 48 rows + its halo row
        p = np.ascontiguousarray(_smooth(64, 64, 9)[:, :49])
        return p[None], z((1,) + p.shape, bool), 3, True
    if name == "img64_halo":
        p = np.ascontiguousarray(_fixture("img64")[:, :33])
        return p[None], z((1,) + p.shape, bool), 3, False
    if name == "saturated":
        p = saturated_planes(64, 64)
        return p[None], z((1,) + p.shape, bool), 0, False
    if name == "batch3":
        a = _fixture("img64")
        p = np.stack([a, np.ascontiguousarray(a[:, ::-1, ::-1]),
                      _smooth(64, 64, 10)])
        return p, _claims(p.shape, 11), 3, False
    raise KeyError(name)


CASES = ["img64", "quilt128", "img64_rf10", "smooth96x80", "smooth_claims",
         "h8", "w8", "h8w8", "halo", "img64_halo", "saturated", "batch3"]


def _jax(planes, claims, rf):
    """gradient_all_device of each image alone: (the 7 accept grids, each
    [B, nty, ntx], the claims [B, 3, h, w])."""
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
    planes, claims, rf, every_pass = _case(case)
    want, want_claims = _jax(planes, claims, rf)
    got_claims = torch.from_numpy(claims.copy())
    got = scoring.gradient_all(torch.from_numpy(planes), got_claims, rf)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bool
        assert np.array_equal(g.numpy(), w), ORDER[k]
    assert np.array_equal(got_claims.numpy(), want_claims)
    if every_pass:
        assert all(w.any() for w in want), [int(w.sum()) for w in want]
    assert any(w.any() for w in want)


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
    want, want_claims = _jax(planes, claims, rf)
    for i in range(planes.shape[0]):
        got, got_claims = block_model(planes[i], claims[i], rf)
        for k, g in enumerate(got):
            assert np.array_equal(g, want[k][i]), (i, ORDER[k])
        assert np.array_equal(got_claims, want_claims[i]), i


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
