"""The port's CUDA kernels, decode and encode on the card (marker `cuda`).

Each kernel is held exactly against its plain PyTorch version on the same
operands, the decode against the goldens and the encode against the host
engine's bytes. Without a card every test
here skips with the reason. This file imports no jax, so it also runs on a
GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from PIL import Image

import yaik_tpu_torch
import torch_covers
from torch_streams import (EDGE_CROPS, craft_t3_stream, d1_operands,
                           digest, edge_crop, ramp_planes, saturated_planes)
from yaik_tpu.decoder import planner as plannermod
from yaik_tpu.decoder import reference as refdec
from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder.context import encode_image as host_encode_image
from yaik_tpu_torch.decoder import pack
from yaik_tpu_torch.encoder import scoring, tables
from yaik_tpu_torch.ops import kernels

FIX = pathlib.Path(__file__).parent / "fixtures"
STANDARD = ["img64", "img128", "quilt128", "img512", "img512b"]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bank():
    return yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())


def _grad_operands(H, W, seed):
    rng = np.random.default_rng(seed)
    accepts = [rng.random((H >> sy, W >> sx)) < 0.3
               for (sx, sy) in pack.GRAD_SHIFTS]
    corners = rng.integers(0, 1 << 24, (7, H // 4 + 1, W // 4 + 1))
    return (torch.from_numpy(corners.astype(np.int32)),
            torch.from_numpy(pack.code4_from_accepts(accepts, H, W)))


@pytest.mark.parametrize("H,W", [(64, 1024), (40, 1288), (512, 512),
                                 (2160, 3840)])
def test_grad_plane_kernel_vs_plain(cuda, H, W):
    c, k = _grad_operands(H, W, seed=H)
    got = kernels.grad_plane(c.to(cuda), k.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.grad_plane_plain(c, k))


@pytest.mark.parametrize("G", [1, 4096, 518400])
def test_t3_merged_kernel_vs_plain(cuda, G, bank):
    """Real table, any row; layer 0 accepts nothing; mx < mn tiles."""
    rng = np.random.default_rng(G)
    tab = pack.lut_table(bank.expanded).tab
    args = [tab,
            rng.integers(0, 128, (2, G, 16)).astype(np.uint8),
            rng.integers(0, 256, (2, G, 6)).astype(np.uint8),
            np.stack([np.zeros(G), rng.integers(0, 2, G)]).astype(np.uint8),
            rng.integers(0, tab.shape[0], (2, G)).astype(np.int32)]
    args = [torch.from_numpy(a) for a in args]
    got = kernels.t3_merged(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.t3_merged_plain(*args))


@pytest.mark.parametrize("H,W", [(40, 1288), (512, 512), (2160, 3840)])
def test_t3_merged_d1_kernel_vs_plain(cuda, H, W, bank):
    """Real table; layer 0 accepts nothing in a third of the blocks; random
    1D operands, so some channels are written by the 1D value alone."""
    rng = np.random.default_rng(H)
    G = (H // 4) * (W // 4)
    tab = pack.lut_table(bank.expanded).tab
    acc = rng.integers(0, 2, (2, G)).astype(np.uint8)
    acc[0, : G // 3] = 0
    args = [torch.from_numpy(a) for a in (
        tab, rng.integers(0, 128, (2, G, 16)).astype(np.uint8),
        rng.integers(0, 256, (2, G, 6)).astype(np.uint8), acc,
        rng.integers(0, tab.shape[0], (2, G)).astype(np.int32))]
    args += [torch.from_numpy(a) for a in d1_operands(rng, G)]
    got = kernels.t3_merged_d1(*(a.to(cuda) for a in args), H, W)
    torch.cuda.synchronize()
    want = kernels.t3_merged_d1_plain(*args, H, W)
    assert torch.equal(got.cpu(), want)
    assert bool((((want >> 24) & 7) == 1).any())


@pytest.mark.parametrize("H,W", [(40, 1288), (2160, 3840)])
def test_grad_plane_final_kernel_vs_plain(cuda, H, W):
    c, k = _grad_operands(H, W, seed=H + 1)
    rng = np.random.default_rng(W)
    vc = torch.from_numpy(rng.integers(0, 1 << 27, (H, W)).astype(np.int32))
    got = kernels.grad_plane_final(c.to(cuda), k.to(cuda), vc.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.grad_plane_final_plain(c, k, vc))


@pytest.mark.parametrize("name", STANDARD + ["bench_4k"])
def test_decode_cuda_fused_matches_split(cuda, name, bank):
    """Both fused flags: one t3_merged_d1 and one grad_plane_final launch,
    no t3_merged or grad_plane, pixels equal to the split form's."""
    stream = (FIX / f"{name}.yaik").read_bytes()
    split = yaik_tpu_torch.decode_image(stream, bank, device=cuda)
    before = {n: getattr(kernels, n).launches for n in (
        "grad_plane", "t3_merged", "t3_merged_d1", "grad_plane_final")}
    got = yaik_tpu_torch.decode_image(stream, bank, device=cuda, t3_d1=True,
                                      grad_final=True)
    after = {n: getattr(kernels, n).launches - k for n, k in before.items()}
    assert after == {"grad_plane": 0, "t3_merged": 0, "t3_merged_d1": 1,
                     "grad_plane_final": 1}
    assert np.array_equal(got, split)


def test_wrapper_refuses_mixed_devices(cuda):
    c, k = _grad_operands(32, 32, seed=0)
    with pytest.raises(ValueError):
        kernels.grad_plane(c.to(cuda), k)


@pytest.mark.parametrize("name", STANDARD)
def test_decode_cuda_matches_golden(cuda, name, bank):
    g0, t0 = kernels.grad_plane.launches, kernels.t3_merged.launches
    got = yaik_tpu_torch.decode_image((FIX / f"{name}.yaik").read_bytes(),
                                      bank, device=cuda)
    assert np.array_equal(got, np.load(FIX / f"{name}.dec.npz")["rgb"])
    assert kernels.grad_plane.launches == g0 + 1
    assert kernels.t3_merged.launches == t0 + 1


def test_decode_cuda_4k_matches_reference(cuda, bank):
    stream = (FIX / "bench_4k.yaik").read_bytes()
    got = yaik_tpu_torch.decode_image(stream, bank, device="cuda")
    assert np.array_equal(got, refdec.decode(stream, bank.expanded))
    plan = plannermod.build_plan(stream, bank.expanded)
    assert (plan.width, plan.height) == (3840, 2160)


@pytest.fixture(scope="module")
def bank3d(cuda):
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module")
def image_4k(cuda, bank):
    return refdec.decode((FIX / "bench_4k.yaik").read_bytes(), bank.expanded)


def _v48_operands(rng, T, P, E):
    """Random values-stage operands (after tests/test_values48.py): dead
    pixels with wild normalizations, one all-dead tile."""
    alive = rng.random((T, P)) < 0.7
    alive[T // 2] = False
    a_c = rng.integers(0, 64, (T, P, 3))
    b_c = np.clip(63 - a_c - rng.integers(0, 2, (T, P, 3)), 0, 63)
    wild = (rng.random((T, P, 3)) < 0.05) & ~alive[:, :, None]
    a_c = np.where(wild, rng.integers(-(1 << 24), 1 << 24, (T, P, 3)), a_c)
    b_c = np.where(wild, rng.integers(-(1 << 24), 1 << 24, (T, P, 3)), b_c)
    ops = [rng.integers(0, 256, (T, P, 3)), alive, a_c, b_c,
           rng.integers(0, 48, (T, E)), rng.integers(0, 200, (T, 3)),
           rng.integers(1, 128, (T, 3)), rng.integers(0, 64, (E, 64, 3)),
           rng.integers(0, 128, (4, E, 64, 3))]
    return [torch.from_numpy(a if a.dtype == bool else a.astype(np.int32))
            for a in ops]


def _pass_operands(planes, bank3d, cuda, shifts):
    """Real operands of the given 3D passes: gradient claims, then the six
    passes in order through the kernels, claims evolving."""
    planes = torch.from_numpy(np.ascontiguousarray(
        planes.transpose(2, 0, 1), np.int32)).to(cuda)
    claims = torch.zeros(planes.shape, dtype=torch.bool, device=cuda)
    scoring.gradient_all(planes, claims, 3)
    tabs = tables.device_tables(bank3d, cuda)
    out = {}
    for (sx, sy) in [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]:
        if (sx, sy) in shifts:
            out[sx, sy] = scoring.tile3d_operands(planes, claims, sx, sy)
        scoring.tile3d_pass(planes, claims, tabs, sx, sy)
    return out, tabs


def _check_grad_score(planes, claims, rf=3):
    """kernels.grad_score on the card, exactly one launch: its packed
    accepts and the claims it leaves equal grad_score_plain's on the same
    operands."""
    c_k, c_p = claims.clone(), claims.clone()
    before = kernels.grad_score.launches
    got = kernels.grad_score(planes, c_k, rf)
    torch.cuda.synchronize()
    assert kernels.grad_score.launches == before + 1
    want = kernels.grad_score_plain(planes, c_p, rf)
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(c_k.cpu(), c_p.cpu())
    return got


@pytest.mark.parametrize("name", ["img64", "quilt128", "img512", "img512b",
                                  "bench_4k"])
def test_grad_score_kernel_vs_plain_fixtures(cuda, name, image_4k):
    img = (image_4k if name == "bench_4k"
           else np.asarray(Image.open(FIX / f"{name}.png")))
    planes = torch.from_numpy(np.ascontiguousarray(
        img[:, :, :3].transpose(2, 0, 1), np.int32)).to(cuda)
    got = _check_grad_score(planes, torch.zeros(
        planes.shape, dtype=torch.bool, device=cuda))
    assert got.any()


@pytest.mark.parametrize("h,w", [(40, 56), (88, 64), (64, 88), (49, 1288),
                                 (545, 512), (17, 16), (3, 5), (1, 17),
                                 (136, 264)])
def test_grad_score_kernel_vs_plain_edges(cuda, h, w):
    """Seeded ramps at h or w % 16 == 8, a band's 16k + 1 rows and shapes
    below a tile, with no claims and with random claims."""
    rng = np.random.default_rng(h * 10007 + w)
    planes = torch.from_numpy(ramp_planes(rng, 1, h, w)[0]).to(cuda)
    _check_grad_score(planes, torch.zeros(planes.shape, dtype=torch.bool,
                                          device=cuda))
    _check_grad_score(planes, torch.from_numpy(
        rng.random(planes.shape) < 0.03).to(cuda))


def test_grad_score_kernel_vs_plain_round6p_clamp(cuda):
    """Tiles that only round6p's clamp at 255 accepts (reject factor 0)."""
    planes = torch.from_numpy(saturated_planes(72, 88)).to(cuda)
    got = _check_grad_score(planes, torch.zeros(
        planes.shape, dtype=torch.bool, device=cuda), 0)
    assert got.any()


@pytest.mark.parametrize("h,w", [(40, 56), (88, 64), (64, 88), (545, 512),
                                 (3, 5), (1, 17)])
@pytest.mark.parametrize("rf", [-1, 255, 300, 2 ** 31 - 1])
def test_grad_score_kernel_vs_plain_reject_factor_edges(cuda, h, w, rf):
    """The reject factor at the ends of the wrapper's clamp to [-1, 255]
    and past it, on seeded ramps at h or w % 16 == 8, a band's 16k + 1
    rows and shapes below a tile, with random claims: the plain version
    takes the factor as it is."""
    rng = np.random.default_rng(h * 10007 + w)
    planes = torch.from_numpy(ramp_planes(rng, 1, h, w)[0]).to(cuda)
    got = _check_grad_score(planes, torch.from_numpy(
        rng.random(planes.shape) < 0.03).to(cuda), rf)
    assert got.any() == (rf >= 0 and min(h, w) >= 4)


@pytest.mark.parametrize("rf", [0, 3, 40, -1, 255, 300, 2 ** 31 - 1])
def test_grad_score_kernel_vs_plain_batch(cuda, rf):
    """B = 4 with random claims: one launch for the batch, each image's
    accepts and claims equal to its own call's."""
    rng = np.random.default_rng(rf & 0xFFFF)
    planes = torch.from_numpy(ramp_planes(rng, 4, 136, 264)).to(cuda)
    claims = torch.from_numpy(rng.random(planes.shape) < 0.03).to(cuda)
    got = _check_grad_score(planes, claims, rf)
    for b in range(4):
        assert torch.equal(got[b], _check_grad_score(planes[b], claims[b],
                                                     rf))


def _check_scores(c, alive, qpts):
    """Both score48 forms equal their plain versions; returns mode48."""
    sums = kernels.score48(c, alive, qpts)
    mode = kernels.score48_mode(c, alive, qpts)
    torch.cuda.synchronize()
    assert torch.equal(sums, kernels.score48_plain(c, alive, qpts))
    assert torch.equal(mode, kernels.score48_mode_plain(c, alive, qpts))
    return mode


def _check_score_values(ops, tabs, accepts_some=True):
    alive = ~ops.mask
    mode = _check_scores(ops.c, alive, tabs.qpts)
    args = (ops.tiles, alive, ops.a_c, ops.b_c, mode, ops.mn, ops.mx - ops.mn,
            tabs.pts, tabs.factors)
    got = kernels.values48(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, kernels.values48_plain(*args)):
        assert torch.equal(g, w)
    assert got[0].any() or not accepts_some


SHIFTS = [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]


@pytest.mark.parametrize("shift", SHIFTS)
def test_score_values_kernels_vs_plain_512(cuda, bank3d, shift):
    img = np.asarray(Image.open(FIX / "img512.png"))
    ops, tabs = _pass_operands(img, bank3d, cuda, [shift])
    _check_score_values(ops[shift], tabs)


def test_score_values_kernels_vs_plain_4k(cuda, bank3d, image_4k):
    ops, tabs = _pass_operands(image_4k, bank3d, cuda, SHIFTS)
    for o in ops.values():
        _check_score_values(o, tabs)


@pytest.mark.parametrize("name", [n for n, (_, _, w) in EDGE_CROPS.items()
                                  if w == 16])
def test_score_values_kernels_vs_plain_16_wide(cuda, bank3d, name):
    """A 16-wide image's dense operands (its 16-wide pass has one tile
    column, the tile block a strided view until made contiguous)."""
    ops, tabs = _pass_operands(edge_crop(name)[..., :3], bank3d, cuda,
                               SHIFTS)
    for o in ops.values():
        _check_score_values(o, tabs, accepts_some=False)


@pytest.mark.parametrize("name", list(EDGE_CROPS))
def test_edge_shape_encode_decode_on_card(cuda, name, bank3d, bank2d):
    """The image sides no fixture has (16 wide, w % 16 == 8): the card's
    stream equals the CPU path's, a second call's and encode_batch's, and
    decodes split and fused to the digest of the JAX package's reference
    decode of its stream (tests/fixtures/edge_digests.json)."""
    from yaik_tpu_torch.encoder import batch
    img = edge_crop(name)
    names = ("score48_mode", "values48")
    before = {n: getattr(kernels, n).launches for n in names}
    got = yaik_tpu_torch.encode_image(img, bank3d, device=cuda)
    after = {n: getattr(kernels, n).launches - k for n, k in before.items()}
    assert after == {"score48_mode": 6, "values48": 6}
    assert got == yaik_tpu_torch.encode_image(img, bank3d, device="cpu")
    assert got == yaik_tpu_torch.encode_image(img, bank3d, device=cuda)
    assert batch.encode_batch([img, img.copy()], bank3d,
                              device=cuda) == [got, got]
    want = json.loads((FIX / "edge_digests.json").read_text())[name]
    for flags in ({}, {"t3_d1": True, "grad_final": True}):
        px = yaik_tpu_torch.decode_image(got, bank2d, device=cuda, **flags)
        assert digest(px) == {"shape": want["shape"],
                              "sha256": want["sha256"]}


@pytest.mark.parametrize("P,E", [(16, 12), (32, 12), (64, 12), (128, 12),
                                 (16, 22), (128, 22), (16, 128), (64, 128),
                                 (128, 128)])
def test_score_values_kernels_vs_plain_random(cuda, P, E):
    """Wild dead pixels in mixed tiles, one all-dead tile; E up to the
    Pallas kernel's 128 LUTs, more than one staged chunk of tables."""
    rng = np.random.default_rng(P + E)
    args = [a.to(cuda) for a in _v48_operands(rng, 1001, P, E)]
    got = kernels.values48(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, kernels.values48_plain(*args)):
        assert torch.equal(g, w)
    c = torch.from_numpy(rng.integers(0, 64, (1001, P, 3)).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, 64, (E, 48, 8, 3)).astype(np.int32))
    mode = _check_scores(c.to(cuda), args[1], q.to(cuda))
    assert not mode[1001 // 2].any()                # the all-dead tile


@pytest.mark.parametrize("P", [16, 128])
def test_score48_mode_first_tie_on_card(cuda, P):
    """Each LUT's 48 patterns are 6 runs of 8 identical ones: equal sums
    must give the first pattern of a run."""
    rng = np.random.default_rng(P)
    q = np.repeat(rng.integers(0, 64, (12, 6, 8, 3)), 8, axis=1)
    c = rng.integers(0, 64, (2001, P, 3))
    alive = torch.from_numpy(rng.random((2001, P)) < 0.5).to(cuda)
    mode = _check_scores(torch.from_numpy(c.astype(np.int32)).to(cuda), alive,
                         torch.from_numpy(q.astype(np.int32)).to(cuda))
    assert not (mode % 8).any()


def test_values48_kernel_all_skip(cuda):
    args = _v48_operands(np.random.default_rng(9), 20, 16, 3)
    args[1] = torch.ones((20, 16), dtype=torch.bool)
    args[8] = torch.full((4, 3, 64, 3), 4000, dtype=torch.int32)
    got = kernels.values48(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert not got[0].any()
    for g, w in zip(got, kernels.values48_plain(*args)):
        assert torch.equal(g.cpu(), w)


def test_pattern_argmin_first_tie_on_card(cuda):
    rng = np.random.default_rng(3)
    sums = rng.integers(100, 200, (500, 12, 48)).astype(np.int32)
    ties = rng.choice(48, (500, 12, 3))
    for k in range(3):
        np.put_along_axis(sums, ties[..., k:k + 1], 7, axis=-1)
    got = kernels.pattern_argmin(torch.from_numpy(sums).to(cuda))
    assert np.array_equal(got.cpu().numpy(), ties.min(-1))


@pytest.mark.parametrize("name", ["img64", "img128"])
def test_encode_cuda_matches_host_engine(cuda, name, bank3d):
    img = np.asarray(Image.open(FIX / f"{name}.png"))
    names = ("score48", "score48_mode", "values48")
    before = {n: getattr(kernels, n).launches for n in names}
    got = yaik_tpu_torch.encode_image(img, bank3d, device=cuda)
    after = {n: getattr(kernels, n).launches - k for n, k in before.items()}
    assert after == {"score48": 0, "score48_mode": 6, "values48": 6}
    assert got == host_encode_image(img, bank3d, engine="host")


def test_entry_points_default_to_the_card(cuda, bank, bank3d):
    """No device argument: decode and encode launch the card's kernels."""
    g0, v0 = kernels.grad_plane.launches, kernels.values48.launches
    got = yaik_tpu_torch.decode_image((FIX / "img64.yaik").read_bytes(), bank)
    assert np.array_equal(got, np.load(FIX / "img64.dec.npz")["rgb"])
    assert kernels.grad_plane.launches == g0 + 1
    img = np.asarray(Image.open(FIX / "img64.png"))
    got = yaik_tpu_torch.encode_image(img, bank3d)
    assert kernels.values48.launches == v0 + 6
    assert got == host_encode_image(img, bank3d, engine="host")


@pytest.fixture(scope="module")
def bank2d():
    return yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes(),
                                     (FIX / "LutFile2D.lut").read_bytes())


FAMILIES = ["bench_2d512", "corr2d128.2d", "bench_ucol512", "img64.ucol",
            "img512.ucol", "gradpair192.gp", "bench_rgba512"]


@pytest.mark.parametrize("G", [1, 4096, 518400])
def test_t2_merged_kernel_vs_plain(cuda, G, bank2d):
    """The tripled 2D table, any row; channel masks 0..7 on both layers."""
    rng = np.random.default_rng(G)
    tab = pack.lut2d_table3(pack.lut2d_table(bank2d.expanded2d))
    args = [tab,
            rng.integers(0, 128, (2, G, 16)).astype(np.uint8),
            rng.integers(0, 256, (2, G, 6)).astype(np.uint8),
            rng.integers(0, 8, (2, G)).astype(np.uint8),
            rng.integers(0, tab.shape[0], (2, G)).astype(np.int32)]
    args = [torch.from_numpy(a) for a in args]
    got = kernels.t2_merged(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.t2_merged_plain(*args))


@pytest.mark.parametrize("shift", [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3),
                                   (2, 2)])
def test_lut_pass_kernel_vs_plain_4k(cuda, shift, bank):
    """Random operands on a 3848x2168 image for every tile size: the
    16-pixel tiles cover it only to 3840x2160, so the rest must read 0."""
    rng = np.random.default_rng(shift[0] * 8 + shift[1])
    (sx, sy), H, W = shift, 2168, 3848
    tw, th = 1 << sx, 1 << sy
    nty, ntx = H // th, W // tw
    g = nty * ntx
    tab = pack.lut_table(bank.expanded).tab
    args = [tab,
            rng.integers(0, 128, (g, th * tw)).astype(np.uint8),
            rng.integers(0, 256, (g, 6)).astype(np.uint8),
            (rng.integers(0, 2, g) * 7).astype(np.uint8),
            rng.integers(0, tab.shape[0], g).astype(np.int32)]
    args = [torch.from_numpy(a) for a in args]
    geo = (nty, ntx, th, tw, H, W)
    got = kernels.lut_pass(*(a.to(cuda) for a in args), *geo)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.lut_pass_plain(*args, *geo))


@pytest.mark.parametrize("name", FAMILIES + ["crafted_3layer"])
def test_family_decode_cuda_matches_reference(cuda, name, bank2d):
    stream = (craft_t3_stream(64, 64, True) if name == "crafted_3layer"
              else (FIX / f"{name}.yaik").read_bytes())
    got = yaik_tpu_torch.decode_image(stream, bank2d, device=cuda)
    want = refdec.decode(stream, bank2d.expanded, bank2d.expanded2d)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_decode_cuda_4k_passes_equal_merged(cuda, bank):
    """bench_4k in the forced per-pass T3 form: six lut_pass launches,
    equal to the merged decode and to the reference."""
    from yaik_tpu_torch.decoder import engine
    stream = (FIX / "bench_4k.yaik").read_bytes()
    plan = plannermod.build_plan(stream, bank.expanded)
    tables = engine.Tables.build(bank.expanded, None, cuda)
    n0 = kernels.lut_pass.launches
    passes = engine.decode_plan(plan, tables, t3_form="passes")
    assert kernels.lut_pass.launches == n0 + 6
    merged = engine.decode_plan(plan, tables, t3_form="merged")
    assert np.array_equal(passes, merged)
    assert np.array_equal(passes, refdec.decode(stream, bank.expanded))


# -- the batch axis --------------------------------------------------------

def _stack_rand(rng, B, G, C):
    return [torch.from_numpy(a) for a in (
        rng.integers(0, 128, (2, B, G, 16)).astype(np.uint8),
        rng.integers(0, 256, (2, B, G, 6)).astype(np.uint8),
        rng.integers(0, 8, (2, B, G)).astype(np.uint8),
        rng.integers(0, C, (2, B, G)).astype(np.int32))]


@pytest.mark.parametrize("H,W", [(40, 1288), (512, 512)])
def test_batched_kernels_vs_plain(cuda, H, W, bank2d):
    """Every decode kernel at B = 4, one launch each, equal to its batched
    plain version; a 16-row pass grid that ends short of 40 rows."""
    rng = np.random.default_rng(H + W)
    B, G = 4, (H // 4) * (W // 4)
    c = [_grad_operands(H, W, seed=H + b) for b in range(B)]
    corners, code4 = torch.stack([x[0] for x in c]), torch.stack(
        [x[1] for x in c])
    vc = torch.from_numpy(rng.integers(0, 1 << 27, (B, H, W)).astype(
        np.int32))
    tab = torch.from_numpy(pack.lut_table(bank2d.expanded).tab)
    tab2 = torch.from_numpy(pack.lut2d_table3(pack.lut2d_table(
        bank2d.expanded2d)))
    lay = _stack_rand(rng, B, G, tab2.shape[0])
    d1 = [torch.from_numpy(np.stack(x, 1)) for x in zip(
        *(d1_operands(rng, G) for _ in range(B)))]
    th, tw = 16, 8
    nty, ntx = H // th, W // tw
    g = nty * ntx
    lp = [torch.from_numpy(a) for a in (
        rng.integers(0, 128, (B, g, th * tw)).astype(np.uint8),
        rng.integers(0, 256, (B, g, 6)).astype(np.uint8),
        (rng.integers(0, 2, (B, g)) * 7).astype(np.uint8),
        rng.integers(0, tab.shape[0], (B, g)).astype(np.int32))]
    calls = {"grad_plane": (corners, code4),
             "grad_plane_final": (corners, code4, vc),
             "t3_merged": (tab, *lay), "t2_merged": (tab2, *lay),
             "t3_merged_d1": (tab, *lay, *d1, H, W),
             "lut_pass": (tab, *lp, nty, ntx, th, tw, H, W)}
    for name, a in calls.items():
        n0 = getattr(kernels, name).launches
        got = getattr(kernels, name)(*(x.to(cuda) if torch.is_tensor(x)
                                       else x for x in a))
        torch.cuda.synchronize()
        assert getattr(kernels, name).launches == n0 + 1
        assert got.shape[0] == B
        assert torch.equal(got.cpu(), getattr(kernels, f"{name}_plain")(*a)), \
            name


@pytest.mark.parametrize("fused", [False, True])
def test_decode_batch_launches_once_per_batch(cuda, bank, fused):
    """A standard batch of 16: one grad_plane and one t3_merged launch
    (fused: one grad_plane_final and one t3_merged_d1), pixels equal to the
    goldens."""
    from yaik_tpu_torch.parallel import batch
    names = ["img512", "img512b"] * 8
    streams = [(FIX / f"{n}.yaik").read_bytes() for n in names]
    kinds = ("grad_plane", "t3_merged", "grad_plane_final", "t3_merged_d1")
    before = {n: getattr(kernels, n).launches for n in kinds}
    got = batch.decode_batch(streams, bank, device=cuda, t3_d1=fused,
                             grad_final=fused)
    after = {n: getattr(kernels, n).launches - k for n, k in before.items()}
    assert after == {"grad_plane": int(not fused), "t3_merged": int(not fused),
                     "grad_plane_final": int(fused),
                     "t3_merged_d1": int(fused)}
    for k, n in enumerate(names):
        assert np.array_equal(got[k], np.load(FIX / f"{n}.dec.npz")["rgb"])


def test_batch_entry_points_default_to_the_card(cuda, bank2d):
    """No device argument: decode_batch, decode_spatial and decode_corpus
    launch the card's kernels, and equal decode_image."""
    from yaik_tpu_torch.parallel import batch
    streams = [(FIX / f"{n}.yaik").read_bytes()
               for n in ("img128", "quilt128", "corr2d128.2d")]
    want = [yaik_tpu_torch.decode_image(s, bank2d, device=cuda)
            for s in streams]
    g0 = kernels.grad_plane.launches
    got = batch.decode_batch(streams[:2], bank2d)
    assert kernels.grad_plane.launches == g0 + 1
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    g0 = kernels.grad_plane.launches
    assert np.array_equal(batch.decode_spatial(streams[2], bank2d,
                                               n_bands=3), want[2])
    assert kernels.grad_plane.launches == g0 + 2     # 48 + 48, then 32 rows
    g0 = kernels.grad_plane.launches
    got = batch.decode_corpus(streams, bank2d, batch_size=2)
    assert kernels.grad_plane.launches == g0 + 2
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_encode_batch_cuda_matches_cpu(cuda, bank3d):
    """encode_batch on the card, one score48_mode and one values48 launch
    per 3D pass for the batch, gives the CPU run's streams; a noise image
    overflows the caps and is encoded alone on the card; encode_corpus and
    encode_image_banded on the card give the same bytes."""
    from yaik_tpu_torch.encoder import batch
    imgs = [np.asarray(Image.open(FIX / f"{n}.png"))
            for n in ("img128", "quilt128")]
    want = batch.encode_batch(imgs, bank3d, device="cpu")
    names = ("score48_mode", "values48")
    before = {n: getattr(kernels, n).launches for n in names}
    got = batch.encode_batch(imgs, bank3d)
    after = {n: getattr(kernels, n).launches - k for n, k in before.items()}
    assert after == {"score48_mode": 6, "values48": 6}
    assert got == want
    noise = np.random.default_rng(3).integers(0, 256, (128, 128, 3),
                                              np.uint8)
    mixed = [imgs[0], noise, imgs[1], imgs[0][:64, :64].copy()]
    streams = [yaik_tpu_torch.encode_image(im, bank3d, device=cuda)
               for im in mixed]
    assert batch.encode_batch(mixed[:3], bank3d, device=cuda) == streams[:3]
    assert batch.encode_corpus(mixed, bank3d, batch_size=2,
                               device=cuda) == streams
    assert batch.encode_image_banded(imgs[1], bank3d, device=cuda,
                                     band_rows=48) == want[1]


def _cover_operands(k, n, seed):
    """k candidate clouds and n tiles near them (so some are covered)."""
    rng = np.random.default_rng(seed)
    cands = rng.integers(0, 64, (k, 64, 3)).astype(np.uint8)
    near = cands[rng.integers(0, k, n)].astype(np.int32)
    tiles = np.clip(near + rng.integers(-6, 7, (n, 64, 3)), 0, 63)
    return [torch.from_numpy(a) for a in (cands, tiles.astype(np.uint8))]


@pytest.mark.parametrize("k,n", [(1, 1), (33, 130), (256, 5000)])
def test_covers_kernel_vs_plain(cuda, k, n):
    c, t = _cover_operands(k, n, k + n)
    before = kernels.covers.launches
    got = kernels.covers(c.to(cuda), t.to(cuda), 75)
    torch.cuda.synchronize()
    assert kernels.covers.launches == before + 1
    assert torch.equal(got.cpu(), kernels.covers_plain(c, t, 75))
    got = kernels.covers(c.to(cuda, torch.int32), t.to(cuda, torch.int32))
    assert torch.equal(got.cpu(), kernels.covers_plain(c, t, 75))


# (k, n, case, gate): the seeded sets (phase 2e's kind) and interleaved
# slots at three sizes; each edge case of tests/torch_covers.py at a k
# and n past the blocks' shapes; every gate on the kernel's dp2a and
# int32 routes; k and n of 1 beside sizes that are no multiple of a block's
COVERS2D_CASES = (
    [(k, n, case, 36) for case in ("seeded", "scatter")
     for k, n in ((1, 1), (33, 130), (256, 5000))]
    + [(33, 4097, case, 36) for case in torch_covers.CASES]
    + [(33, 130, case, gate) for case in ("seeded", "wide")
       for gate in torch_covers.GATES]
    + [(257, 1, case, 36) for case in ("seeded", "empty_tiles", "wide")]
    + [(33, 4097, "tiny_tiles", gate) for gate in (0, 2 ** 31 - 1)])


@pytest.mark.parametrize("k,n,case,gate", COVERS2D_CASES)
def test_covers2d_kernel_vs_plain(cuda, k, n, case, gate):
    """The kernel bit for bit against the plain version (tests/
    torch_covers.py's cases: empty and full candidates and tiles, tiles
    of 0..2 pixels, interleaved live and pad slots with arbitrary pad
    values, i32 coordinates up to 4096), as i32 and, where every live
    coordinate fits, as u8 operands."""
    ops = [torch.from_numpy(a) for a in torch_covers.operands(
        case, k, n, k + n)]
    want = kernels.covers2d_plain(*(a.to(cuda) for a in ops), gate=gate)
    before = kernels.covers2d.launches
    got = kernels.covers2d(*(a.to(cuda) for a in ops), gate=gate)
    torch.cuda.synchronize()
    assert kernels.covers2d.launches == before + 1
    assert torch.equal(got, want)
    if case != "wide":
        u8 = [a.to(cuda, torch.uint8) if a.dtype == torch.int32 else
              a.to(cuda) for a in ops]
        assert torch.equal(kernels.covers2d(*u8, gate=gate), want)


def test_covers2d_kernel_takes_unaligned_views(cuda):
    """Contiguous views that start off the kernel's 8- and 16-byte loads
    (the wrapper copies them) give the plain version's matrix."""
    ops = [torch.from_numpy(a).to(cuda)
           for a in torch_covers.operands("seeded", 33, 130, 1)]

    def shifted(a, by):
        buf = torch.zeros(a.numel() + by, dtype=a.dtype, device=cuda)
        view = buf[by:].view(a.shape)
        view.copy_(a)
        return view
    views = [shifted(ops[0], 1), ops[1], shifted(ops[2], 1),
             shifted(ops[3], 3)]
    assert all(v.is_contiguous() for v in views)
    assert views[3].data_ptr() % 16 and views[2].data_ptr() % 8
    assert torch.equal(kernels.covers2d(*views),
                       kernels.covers2d_plain(*ops))


def test_encode_rgba_and_passes_cuda_matches_cpu(cuda, bank3d):
    """RGBA (sprite256) and every pass the reference leaves disabled
    (img64, 2D with tests/fixtures/Bank2D): the card's streams equal the
    CPU run's."""
    from yaik_tpu_torch.encoder import bank2d as bank2dmod
    from yaik_tpu_torch.encoder.context import EncoderConfig
    b2 = bank2dmod.load_bank2d(str(FIX / "Bank2D"))
    cfg = EncoderConfig(enable_single_color=True, enable_smooth_map=True,
                        enable_2d=True, enable_plnt=True,
                        enable_plane_gradients=True)
    for name, config in (("sprite256", None), ("img64", cfg)):
        img = np.asarray(Image.open(FIX / f"{name}.png"))
        got = yaik_tpu_torch.encode_image(img, bank3d, device=cuda,
                                          config=config, bank2d=b2)
        assert got == yaik_tpu_torch.encode_image(img, bank3d, device="cpu",
                                                  config=config, bank2d=b2)


def test_mine_bank_cuda_matches_cpu(cuda, tmp_path):
    from yaik_tpu_torch.encoder import mining
    imgs = [np.asarray(Image.open(FIX / f"{n}.png")) for n in ("img128",
                                                               "quilt128")]
    before = kernels.covers.launches
    got = mining.mine_bank(imgs, tmp_path / "cuda")
    assert kernels.covers.launches == before + 1
    assert got == mining.mine_bank(imgs, tmp_path / "cpu", device="cpu")
    for f in (tmp_path / "cpu").iterdir():
        assert (tmp_path / "cuda" / f.name).read_bytes() == f.read_bytes()
    got = mining.mine_bank2d(imgs[:1], tmp_path / "cuda2")
    assert got == mining.mine_bank2d(imgs[:1], tmp_path / "cpu2",
                                     device="cpu")
    for f in (tmp_path / "cpu2").iterdir():
        assert (tmp_path / "cuda2" / f.name).read_bytes() == f.read_bytes()


def test_split_over_a_repeated_card_counts_launches_per_device(cuda, bank):
    """decode_batch over [cuda:0] * 2: each slice launches the split
    decode's kernels once, and `per_device` counts both on the card."""
    from yaik_tpu_torch.parallel import batch
    streams = [(FIX / "img128.yaik").read_bytes()] * 2
    kernels.grad_plane.per_device.clear()
    kernels.t3_merged.per_device.clear()
    got = batch.decode_batch(streams, bank, devices=[cuda] * 2)
    assert kernels.grad_plane.per_device == {cuda: 2}
    assert kernels.t3_merged.per_device == {cuda: 2}
    want = np.load(FIX / "img128.dec.npz")["rgb"]
    assert all(np.array_equal(g, want) for g in got)
