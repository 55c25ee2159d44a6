"""The port's kernels (yaik_tpu_torch.ops.kernels) against the TPU kernels
they replace.

On the CPU the wrappers run their plain PyTorch versions; those are held
exactly (tolerance 0: the arithmetic is integer, or float32 in one stated
op order) against the Pallas kernels in interpret mode and against the JAX
engine's and scoring's XLA forms, on the same operands made with numpy.
tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_values48 import _rand_inputs
from torch_streams import d1_operands
from yaik_tpu.decoder import jax_engine as je
from yaik_tpu.encoder import jax_scoring as js
from yaik_tpu.encoder.corr3d import SWAP3D
from yaik_tpu.ops import pallas_kernels as pk
from yaik_tpu_torch import convert
from yaik_tpu_torch.decoder import pack
from yaik_tpu_torch.ops import kernels


def _grad_operands(H, W, seed):
    """Random gradient passes: 7 accept grids (30% of tiles) and 7 corner
    grids, as the planner gives them."""
    rng = np.random.default_rng(seed)
    qh, qw = H // 4 + 1, W // 4 + 1
    accepts, corners = [], []
    for (sx, sy) in je.GRAD_SHIFTS:
        accepts.append(rng.random((H >> sy, W >> sx)) < 0.3)
        corners.append(rng.integers(0, 256, (qh, qw, 3)).astype(np.uint8))
    c = np.stack(corners).astype(np.int32)
    packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    code4 = pack.code4_from_accepts(accepts, H, W)
    return accepts, corners, packed, code4


def _blend_chain(accepts, corners, H, W):
    plane = jnp.full((H, W), 0x808080, jnp.uint32)
    for k, (sx, sy) in enumerate(je.GRAD_SHIFTS):
        plane = je._blend_pass(plane, jnp.asarray(accepts[k]),
                               jnp.asarray(corners[k]), sx, sy)
    return np.asarray(plane).view(np.int32)


def _blend_over_background(g):
    plane = torch.full(g.shape, 0x808080, dtype=torch.int32)
    return (plane ^ ((plane ^ g) & (((g >> 24) & 1) * 0xFFFFFF))).numpy()


@pytest.mark.parametrize("H,W", [(64, 64), (64, 1024), (96, 128)])
def test_grad_plane_plain_vs_pallas_and_blend_chain(H, W):
    """grad_plane_plain == the Pallas grad_plane (interpret mode, on the JAX
    engine's compact corner layout) word for word, and blended over the
    background == the sequential 7x _blend_pass chain."""
    accepts, corners, packed, code4 = _grad_operands(H, W, seed=H + W)
    got = kernels.grad_plane(torch.from_numpy(packed),
                             torch.from_numpy(code4))
    wy, bxc, r4y, r4x = je._grad_consts(H, W)
    corn = je._pack_grad_corners_host(np.stack(corners), H, W)
    want = np.asarray(pk.grad_plane(
        jnp.asarray(corn), jnp.asarray(code4.astype(np.int32)), wy, bxc,
        r4y, r4x, shifts=je.GRAD_SHIFTS, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_blend_over_background(got),
                          _blend_chain(accepts, corners, H, W))


def test_grad_plane_plain_wide_ragged_vs_blend_chain():
    """No width gate and H not a multiple of 16 (the Pallas kernel takes
    neither): 40x1288 against the blend chain alone."""
    H, W = 40, 1288
    accepts, corners, packed, code4 = _grad_operands(H, W, seed=7)
    got = kernels.grad_plane(torch.from_numpy(packed),
                             torch.from_numpy(code4))
    assert np.array_equal(_blend_over_background(got),
                          _blend_chain(accepts, corners, H, W))


def _t3_layer(rng, G, rows, idx_hi=64, acc=None):
    idx = rng.integers(0, idx_hi, (G, 16)) | (rng.integers(0, 2, (G, 16)) << 6)
    cols = rng.integers(0, 256, (G, 6))               # mx < mn included
    a = rng.integers(0, 2, G) if acc is None else np.full(G, acc)
    r = rng.choice(rows, G)
    return (idx.astype(np.uint8), cols.astype(np.uint8), a.astype(np.uint8),
            r.astype(np.int32))


def _t3_operands(layers):
    return [np.stack([l[i] for l in layers]) for i in range(4)]


def _t3_plain(tab, idx16, cols, acc, rows):
    return kernels.t3_merged(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in (tab, idx16, cols, acc, rows))
                             ).numpy()


def _dict2p(tab, idx16, cols, acc, rows):
    d, idx4, cols2, tab3 = convert.to_jax_t3(tab, idx16, cols, acc, rows)
    out = pk.lut3d_vals_dict2p(
        jnp.asarray(idx4[0]), jnp.asarray(idx4[1]), jnp.asarray(tab3),
        jnp.asarray(cols2[0]), jnp.asarray(cols2[1]), interpret=True)
    return np.asarray(out).T                              # [G4, 16]


def _assert_written_lanes_equal(got, want):
    # lut3d_vals_dict2p's contract: write bits equal everywhere, payload
    # equal where written (its per-block elision skips dead lanes)
    assert np.array_equal(got >> 24, want >> 24)
    w = (want >> 24) != 0
    assert np.array_equal((got & 0xFFFFFF)[w], (want & 0xFFFFFF)[w])


def _small_tab(rng, C=300):
    """A packed table of entries 0..128 (the int8 dictionary's range)."""
    e = rng.integers(0, 129, (C, 64, 3)).astype(np.int32)
    return e[..., 0] | (e[..., 1] << 8) | (e[..., 2] << 16)


def test_t3_merged_plain_vs_dict2p():
    rng = np.random.default_rng(13)
    tab = _small_tab(rng)
    rows = rng.choice(tab.shape[0], 48, replace=False)
    G = 100
    ops = _t3_operands([_t3_layer(rng, G, rows), _t3_layer(rng, G, rows)])
    got = _t3_plain(tab, *ops)
    assert got.shape == (G, 16) and got.dtype == np.int32
    _assert_written_lanes_equal(got, _dict2p(tab, *ops))


@pytest.mark.parametrize("tier", ["empty_layer", "shallow", "deep_forced"])
def test_t3_merged_plain_vs_dict2p_elision_tiers(tier):
    """The Pallas kernel's per-block elision tiers (an empty layer; all
    indices < 16; one idx=16 byte forcing the deep tree), as in
    tests/test_round3_fastpaths.py: the plain version computes every lane
    and must agree on every written one."""
    rng = np.random.default_rng(17)
    tab = _small_tab(rng)
    rows = rng.choice(tab.shape[0], 8, replace=False)
    G = 64
    if tier == "empty_layer":
        a = _t3_layer(rng, G, rows, acc=0)
        a = (a[0] | (1 << 6),) + a[1:]
    elif tier == "shallow":
        a = _t3_layer(rng, G, rows, idx_hi=16, acc=1)
        a = (a[0] | (1 << 6),) + a[1:]
    else:
        a = _t3_layer(rng, G, rows, idx_hi=16, acc=1)
        a[0][3, 5] = 16 | (a[0][3, 5] & 64)
    b = _t3_layer(rng, G, rows, idx_hi=16, acc=1)
    b = (b[0] | (1 << 6),) + b[1:]
    ops = _t3_operands([a, b])
    _assert_written_lanes_equal(_t3_plain(tab, *ops), _dict2p(tab, *ops))


def test_t3_merged_plain_vs_two_lut3d_vals(expanded_tab):
    """On the real LutFile table (rows anywhere in it, entries up to 251)
    and beyond any dictionary: == two lut3d_vals layers composed B over A,
    on every lane."""
    rng = np.random.default_rng(19)
    tab = expanded_tab
    rows = np.arange(tab.shape[0])
    G = 300
    ops = _t3_operands([_t3_layer(rng, G, rows), _t3_layer(rng, G, rows)])
    idx16, cols, acc, rws = ops
    vs = []
    for L in range(2):
        cols7 = np.concatenate([cols[L].astype(np.int32),
                                acc[L][:, None].astype(np.int32)], axis=1)
        vs.append(np.asarray(pk.lut3d_vals(
            jnp.asarray(idx16[L].T.astype(np.int32)),
            jnp.asarray(tab[rws[L]].T), jnp.asarray(cols7.T),
            interpret=True)).T)
    va, vb = vs
    wa, wb = va >> 24, vb >> 24
    want = (np.where(wb != 0, vb & 0xFFFFFF, va & 0xFFFFFF)
            | ((wa | wb) << 24))
    assert np.array_equal(_t3_plain(tab, *ops), want)


@pytest.fixture(scope="module")
def expanded_tab():
    import pathlib

    from yaik_tpu.format import lut as lutmod
    fix = pathlib.Path(__file__).parent / "fixtures"
    return pack.lut_table(lutmod.expand_lut(lutmod.parse_lut_file(
        (fix / "LutFile.lut").read_bytes()))).tab


def test_wrappers_route_cpu_to_plain_and_check_operands():
    """CPU tensors take the plain version (no launch is counted); wrong
    dtype, shape or layout raises before any kernel could see it."""
    accepts, corners, packed, code4 = _grad_operands(32, 32, seed=3)
    c, k = torch.from_numpy(packed), torch.from_numpy(code4)
    before = kernels.grad_plane.launches
    assert torch.equal(kernels.grad_plane(c, k),
                       kernels.grad_plane_plain(c, k))
    assert kernels.grad_plane.launches == before
    with pytest.raises(TypeError):
        kernels.grad_plane(c.to(torch.int64), k)
    with pytest.raises(ValueError):
        kernels.grad_plane(c[:, :-1], k)
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(_small_tab(rng, 40))
    ops = [torch.from_numpy(x) for x in _t3_operands(
        [_t3_layer(rng, 10, np.arange(40)) for _ in range(2)])]
    before = kernels.t3_merged.launches
    kernels.t3_merged(tab, *ops)
    assert kernels.t3_merged.launches == before
    with pytest.raises(ValueError):
        kernels.t3_merged(tab, ops[0].transpose(1, 2).contiguous()
                          .transpose(1, 2), *ops[1:])
    with pytest.raises(TypeError):
        kernels.t3_merged(tab, ops[0], ops[1], ops[2], ops[3].to(torch.int64))


def _score_operands(rng, T, P, E):
    c = rng.integers(0, 64, (T, P, 3)).astype(np.int32)
    alive = rng.random((T, P)) < 0.7
    alive[T // 2] = False                      # one all-dead tile
    qpts = rng.integers(0, 64, (E, 48, 8, 3)).astype(np.int32)
    return c, alive, qpts


@pytest.mark.parametrize("P", [16, 128])
def test_score48_plain_vs_pallas_and_xla(P):
    """score48_plain == the Pallas score48 (interpret mode) == the dense
    XLA form tile3d_score_device, every sum."""
    c, alive, qpts = _score_operands(np.random.default_rng(P), 37, P, 12)
    got = kernels.score48(*(torch.from_numpy(a) for a in (c, alive, qpts)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (37, 12, 48)
    j = [jnp.asarray(a) for a in (c, alive, qpts)]
    assert np.array_equal(got.numpy(), np.asarray(js.tile3d_score_device(*j)))
    assert np.array_equal(got.numpy(),
                          np.asarray(pk.score48(*j, interpret=True)))


def test_pattern_argmin_takes_the_first_tie():
    """mode48 keeps the reference's first-min rule on equal sums, as
    jnp.argmin does in tile3d_pass_resident."""
    rng = np.random.default_rng(3)
    sums = rng.integers(100, 200, (50, 12, 48)).astype(np.int32)
    ties = rng.choice(48, (50, 12, 3))
    for k in range(3):                      # three patterns share the min
        np.put_along_axis(sums, ties[..., k:k + 1], 7, axis=-1)
    sums[0, 0] = 5                          # all 48 equal
    got = kernels.pattern_argmin(torch.from_numpy(sums)).numpy()
    assert got.dtype == np.int32
    want = ties.min(-1)
    want[0, 0] = 0
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jnp.argmin(sums, -1)))


def _v48_idx_numpy(args, tile_type):
    """The chosen window's first-min idx of every pixel, in numpy float32
    with the stated op order ((d0^2 + d1^2) + d2^2), nothing contracted."""
    tiles, alive, a_c, b_c, mode48, mn, d, pts, factors = args
    T, P, _ = tiles.shape
    out = np.zeros((T, P), np.int64)
    for t in range(T):
        e = (tile_type[t] >> 6) & 0xFF
        step, n = kernels.V48_WINDOWS[3 - (tile_type[t] >> 14)]
        m = mode48[t, e]
        perm = SWAP3D[m >> 3]
        ms = np.where([(m >> s) & 1 for s in range(3)], b_c[t], a_c[t])
        mf = ms[:, list(perm)].astype(np.float32)                # [P, 3]
        dd = mf[:, None, :] - pts[e, ::step][:n].astype(np.float32)[None]
        sq = dd * dd
        out[t] = np.argmin((sq[..., 0] + sq[..., 1]) + sq[..., 2], -1)
    return out


def _assert_values_equal(got, want, args):
    """accept and tile_type equal everywhere, idx on every alive pixel,
    and every idx equals the numpy reference of the stated op order. The
    JAX form on the CPU may differ only on a wild dead pixel (|normalization|
    > 2^12, so its squares pass 2^24 and round): XLA contracts its distance
    sum into FMAs there (ROADMAP Queue 3). Emission never reads a dead
    pixel's idx."""
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    alive = args[1]
    assert np.array_equal(got[2][alive], want[2][alive])
    assert np.array_equal(got[2], _v48_idx_numpy(args, got[1]))
    for t, p in np.argwhere(got[2] != want[2]):
        assert np.abs(np.stack([args[2][t, p], args[3][t, p]])).max() > 4096


@pytest.mark.parametrize("P,E", [(16, 12), (32, 12), (64, 12), (128, 12),
                                 (16, 22)])
def test_values48_plain_vs_xla(P, E):
    """values48_plain == tile3d_values_device (the TPU's default values
    stage) on random operands with wild dead pixels and an all-dead tile,
    at every production tile size and a bank wider than the fixture's."""
    args = _rand_inputs(np.random.default_rng(5 + P + E), 70, P, E)
    got = [x.numpy() for x in kernels.values48(
        *(torch.from_numpy(a) for a in args))]
    assert got[0].dtype == bool and got[1].dtype == np.int32
    assert got[2].dtype == np.int32 and got[2].shape == (70, P)
    want = [np.asarray(x) for x in js.tile3d_values_device(
        *(jnp.asarray(a) for a in args))]
    _assert_values_equal(got, want, args)


def test_values48_plain_vs_pallas():
    """values48_plain == the Pallas values48 (interpret mode)."""
    args = _rand_inputs(np.random.default_rng(21), 70, 16, 12)
    got = [x.numpy() for x in kernels.values48(
        *(torch.from_numpy(a) for a in args))]
    want = [np.asarray(x) for x in pk.values48(
        *(jnp.asarray(a) for a in args), interpret=True)]
    _assert_values_equal(got, want, args)


def test_values48_plain_all_skip():
    """No tile takes any LUT (factors 4000): accept all false, and the
    e = 0, mode 3, window-0 tail equals the XLA form's."""
    rng = np.random.default_rng(9)
    args = list(_rand_inputs(rng, 20, 16, 3))
    args[1] = np.ones((20, 16), bool)
    args[8] = np.full((4, 3, 64, 3), 4000, np.int32)
    got = [x.numpy() for x in kernels.values48(
        *(torch.from_numpy(a) for a in args))]
    want = [np.asarray(x) for x in js.tile3d_values_device(
        *(jnp.asarray(a) for a in args))]
    assert not got[0].any()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_plain_chunking_is_invisible(monkeypatch):
    """The plain versions' tile chunks do not change their outputs."""
    args = [torch.from_numpy(a) for a in
            _rand_inputs(np.random.default_rng(4), 50, 32, 5)]
    c, alive, qpts = (torch.from_numpy(a) for a in _score_operands(
        np.random.default_rng(4), 50, 32, 5))
    whole = (kernels.values48_plain(*args),
             kernels.score48_plain(c, alive, qpts))
    monkeypatch.setattr(kernels, "VALUES_CHUNK_PX", 96)
    monkeypatch.setattr(kernels, "SCORE_CHUNK_PX", 96)
    for g, w in zip(kernels.values48_plain(*args), whole[0]):
        assert torch.equal(g, w)
    assert torch.equal(kernels.score48_plain(c, alive, qpts), whole[1])


def test_score_values_wrappers_route_cpu_and_check_operands():
    rng = np.random.default_rng(6)
    c, alive, qpts = (torch.from_numpy(a) for a in
                      _score_operands(rng, 8, 16, 2))
    before = kernels.score48.launches
    assert torch.equal(kernels.score48(c, alive, qpts),
                       kernels.score48_plain(c, alive, qpts))
    assert kernels.score48.launches == before
    with pytest.raises(TypeError):
        kernels.score48(c.to(torch.int64), alive, qpts)
    with pytest.raises(ValueError):
        kernels.score48(c, alive[:, :8], qpts)
    args = [torch.from_numpy(a) for a in _rand_inputs(rng, 8, 16, 2)]
    before = kernels.values48.launches
    kernels.values48(*args)
    assert kernels.values48.launches == before
    with pytest.raises(TypeError):
        kernels.values48(*args[:4], args[4].to(torch.int64), *args[5:])
    with pytest.raises(ValueError):
        kernels.values48(*args[:8], args[8][:, :1].contiguous())


def _tie_qpts(rng, E):
    """Each LUT's 48 patterns as 6 runs of 8 identical ones: equal sums."""
    return np.repeat(rng.integers(0, 64, (E, 6, 8, 3)), 8, axis=1).astype(
        np.int32)


@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("ties", [False, True])
def test_score48_mode_plain_vs_pallas_and_xla(P, ties):
    """score48_mode (the plain version on the CPU) == jnp.argmin over the
    Pallas score48 (interpret mode) and over tile3d_score_device, with an
    all-dead tile (mode 0) and, with `ties`, runs of identical patterns
    whose equal sums must give the run's first pattern."""
    rng = np.random.default_rng(P + ties)
    c, alive, qpts = _score_operands(rng, 37, P, 12)
    if ties:
        qpts = _tie_qpts(rng, 12)
    before = kernels.score48_mode.launches
    got = kernels.score48_mode(*(torch.from_numpy(a)
                                 for a in (c, alive, qpts))).numpy()
    assert kernels.score48_mode.launches == before
    assert got.dtype == np.int32 and got.shape == (37, 12)
    j = [jnp.asarray(a) for a in (c, alive, qpts)]
    assert np.array_equal(
        got, np.asarray(jnp.argmin(pk.score48(*j, interpret=True), -1)))
    assert np.array_equal(
        got, np.asarray(jnp.argmin(js.tile3d_score_device(*j), -1)))
    assert not got[37 // 2].any()                   # the all-dead tile
    if ties:
        assert not (got % 8).any()


def test_score48_mode_wrapper_routes_cpu_and_checks_operands():
    c, alive, qpts = (torch.from_numpy(a) for a in _score_operands(
        np.random.default_rng(8), 8, 16, 2))
    before = kernels.score48_mode.launches
    assert torch.equal(kernels.score48_mode(c, alive, qpts),
                       kernels.pattern_argmin(
                           kernels.score48_plain(c, alive, qpts)))
    assert kernels.score48_mode.launches == before
    with pytest.raises(TypeError):
        kernels.score48_mode(c, alive.to(torch.uint8), qpts)
    with pytest.raises(ValueError):
        kernels.score48_mode(c, alive, qpts[:, :47].contiguous())


@pytest.mark.parametrize("P", [16, 64, 128])
def test_values48_decision_ignores_dead_pixels(P):
    """The premise of the kernel's phase 1: accept, tile_type and every
    alive pixel's idx do not change when the dead pixels' a_c/b_c are
    replaced by random values in +-5000."""
    rng = np.random.default_rng(40 + P)
    args = list(_rand_inputs(rng, 60, P, 12))
    want = kernels.values48_plain(*(torch.from_numpy(a) for a in args))
    dead = ~args[1][:, :, None]
    for k in (2, 3):
        args[k] = np.where(dead, rng.integers(-5000, 5001, args[k].shape),
                           args[k]).astype(np.int32)
    got = kernels.values48_plain(*(torch.from_numpy(a) for a in args))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    alive = torch.from_numpy(args[1])
    assert torch.equal(got[2][alive], want[2][alive])


def test_values48_all_dead_tiles_take_the_last_lut_window_3():
    """On a tile with no alive pixel, window 3 of every LUT takes it with
    diff 0 and the scan's ties go to the later LUT: e_sel = E - 1,
    bitmode 0, and every idx is the first-min point of that LUT's 8-point
    window (dead pixels' wild normalizations included)."""
    rng = np.random.default_rng(12)
    args = list(_rand_inputs(rng, 40, 16, 7))
    args[1][::3] = False
    acc, tile_type, idx = (x.numpy() for x in kernels.values48_plain(
        *(torch.from_numpy(a) for a in args)))
    dead = ~args[1].any(1)
    assert dead.sum() >= 13
    assert acc[dead].all()
    assert (((tile_type[dead] >> 6) & 0xFF) == 6).all()
    assert ((tile_type[dead] >> 14) == 0).all()
    assert np.array_equal(tile_type[dead] & 63, args[4][dead, 6])
    assert np.array_equal(idx[dead], _v48_idx_numpy(args, tile_type)[dead])


def _pass_operands(rng, G, P, R, entry_hi=129):
    """Random LUT-pass operands: raw idx | wmask<<6 bytes, min/max colours
    (mx < mn included), 0/1 accepts, rows into an R-row table of entries
    below entry_hi."""
    e = rng.integers(0, entry_hi, (R, 64, 3)).astype(np.int64)
    tab = (e[..., 0] | (e[..., 1] << 8) | (e[..., 2] << 16)).astype(np.int32)
    raw = (rng.integers(0, 64, (G, P))
           | (rng.integers(0, 2, (G, P)) << 6)).astype(np.uint8)
    cols = rng.integers(0, 256, (G, 6)).astype(np.uint8)
    acc = rng.integers(0, 2, G).astype(np.uint8)
    rows = rng.integers(0, R, G).astype(np.int32)
    return e, tab, raw, cols, acc, rows


def _lut_pass(tab, raw, cols, chm, rows, nty, ntx, th, tw, H, W):
    return kernels.lut_pass(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (tab, raw, cols, chm, rows)),
                            nty, ntx, th, tw, H, W).numpy()


def _image_of(vp, nty, ntx, th, tw, H, W):
    """Tile-major [G, P] pass words with bit 24 the write bit -> the
    lut_pass contract: [H, W], written pixels v | 7 << 24, 0 elsewhere."""
    vp = np.where(((vp >> 24) & 1) != 0, (vp & 0xFFFFFF) | (7 << 24), 0)
    img = np.zeros((H, W), np.int32)
    img[: nty * th, : ntx * tw] = vp.reshape(nty, ntx, th, tw).transpose(
        0, 2, 1, 3).reshape(nty * th, ntx * tw)
    return img


@pytest.mark.parametrize("form", ["lut3d_vals", "lut3d_vals_dict"])
def test_lut_pass_plain_vs_pallas(form):
    """lut_pass_plain == the Pallas lut3d_vals (per-tile gathered tables)
    and lut3d_vals_dict (a 32-row dictionary) in interpret mode, after
    their relayout to image order, on a 4-row x 8-column tile pass whose
    grid (12 x 40) is smaller than the 16 x 48 image."""
    rng = np.random.default_rng(31)
    nty, ntx, th, tw, H, W = 3, 5, 4, 8, 16, 48
    G, P = nty * ntx, th * tw
    e, tab, raw, cols, acc, rows = _pass_operands(rng, G, P, 32)
    got = _lut_pass(tab, raw, cols, acc * 7, rows, nty, ntx, th, tw, H, W)
    cols7 = np.concatenate([cols, acc[:, None]], 1).astype(np.int32)
    if form == "lut3d_vals":
        vp = pk.lut3d_vals(jnp.asarray(raw.T.astype(np.int32)),
                           jnp.asarray(tab[rows].T), jnp.asarray(cols7.T),
                           interpret=True)
    else:
        tab3 = np.concatenate([e[:, :, c].T for c in range(3)], axis=0)
        cols8 = np.concatenate([cols7, rows[:, None]], 1)
        vp = pk.lut3d_vals_dict(jnp.asarray(raw.T.astype(np.int32)),
                                jnp.asarray(tab3, dtype=jnp.bfloat16),
                                jnp.asarray(cols8.T), interpret=True)
    want = _image_of(np.asarray(vp).T, nty, ntx, th, tw, H, W)
    assert np.array_equal(got, want)
    assert got[: nty * th, : ntx * tw].any() and not got[12:].any()


def test_lut_pass_serves_lut3d_tree():
    """The oracle-only lut3d_tree (#1) on its test operands
    (tests/test_ops.py): lut_pass with every write bit set, colours
    mn = 0, mx = 128 and a table row per tile returns each entry exactly."""
    rng = np.random.default_rng(1)
    G, Pn = 70, 16
    idx = rng.integers(0, 64, (G, Pn)).astype(np.int32)
    luts = rng.integers(0, 129, (G, 64, 3)).astype(np.int32)
    tab = luts[:, :, 0] | (luts[:, :, 1] << 8) | (luts[:, :, 2] << 16)
    want = np.asarray(pk.lut3d_tree(jnp.asarray(idx.T), jnp.asarray(tab.T),
                                    interpret=True)).T
    cols = np.tile(np.array([0, 0, 0, 128, 128, 128], np.uint8), (G, 1))
    img = _lut_pass(tab, (idx | 64).astype(np.uint8), cols,
                    np.full(G, 7, np.uint8), np.arange(G, dtype=np.int32),
                    7, 10, 4, 4, 28, 40)
    got = img.reshape(7, 4, 10, 4).transpose(0, 2, 1, 3).reshape(G, 16)
    assert np.array_equal(got & 0xFFFFFF, want)
    assert ((got >> 24) == 7).all()


def test_t3_merged_serves_lut3d_vals_dict2():
    """The oracle-only lut3d_vals_dict2 (#9) on its test operands
    (tests/test_round3_fastpaths.py): t3_merged with the dictionary rows as
    the table equals it on every lane."""
    rng = np.random.default_rng(9)
    G, P, U = 80, 16, 48
    tabs = rng.integers(0, 129, (U, 64, 3)).astype(np.int64)
    tab3 = np.concatenate([tabs[:, :, c].T for c in range(3)], axis=0)

    def layer():
        idx = rng.integers(0, 64, (G, P)).astype(np.int32)
        wm = rng.integers(0, 2, (G, P)).astype(np.int32)
        cols8 = np.zeros((G, 8), np.int32)
        cols8[:, 0:3] = rng.integers(0, 256, (G, 3))
        cols8[:, 3:6] = rng.integers(0, 256, (G, 3))
        cols8[:, 6] = rng.integers(0, 2, G)
        cols8[:, 7] = rng.integers(0, U, G)
        return (idx | (wm << 6)), cols8

    (rawa, colsa), (rawb, colsb) = layer(), layer()
    want = np.asarray(pk.lut3d_vals_dict2(
        jnp.asarray(rawa.T), jnp.asarray(rawb.T),
        jnp.asarray(tab3, dtype=jnp.bfloat16), jnp.asarray(colsa.T),
        jnp.asarray(colsb.T), interpret=True)).T
    tab = (tabs[..., 0] | (tabs[..., 1] << 8) | (tabs[..., 2] << 16))
    c8 = np.stack([colsa, colsb])
    got = _t3_plain(tab.astype(np.int32), np.stack([rawa, rawb]).astype(
        np.uint8), c8[..., :6].astype(np.uint8), c8[..., 6].astype(np.uint8),
        c8[..., 7])
    assert np.array_equal(got, want)


def test_t2_merged_plain_vs_dict2p_chan():
    """t2_merged_plain == lut3d_vals_dict2p(chan=True) in interpret mode on
    overlapping 2D passes of two modes (tests/test_t2_merged.py's synthetic
    layers; the JAX dictionary form through jax_engine._t2_pack_dict, the
    port's full rows from pack.t2_merge_layers): write bits equal on every
    lane, values on every written channel."""
    import pathlib
    from types import SimpleNamespace

    from test_t2_merged import _synth_pass
    from yaik_tpu.format import lut as lutmod
    fix = pathlib.Path(__file__).parent / "fixtures"
    exp2d = lutmod.expand_lut2d(lutmod.parse_lut2d_file(
        (fix / "LutFile2D.lut").read_bytes()))
    rng = np.random.default_rng(11)
    h = w = 64
    plan = SimpleNamespace(height=h, width=w, tile2d=[
        _synth_pass(rng, 0, (3, 3), 8, 8, rng.random((8, 8)) < 0.7),
        _synth_pass(rng, 1, (2, 2), 16, 16, rng.random((16, 16)) < 0.7)])
    d, (chma, idx4a, cols2a), (chmb, idx4b, cols2b) = je._t2_pack_dict(
        je.t2_merge_plan(plan, exp2d), exp2d)
    ls = np.asarray(je.lut2d_device_table3(exp2d)[0])[d]
    tab3 = (np.concatenate([(ls >> (8 * c)) & 0xFF for c in range(3)],
                           axis=1).T - 1).astype(np.int8)
    want = np.asarray(pk.lut3d_vals_dict2p(
        *(jnp.asarray(x) for x in (idx4a, idx4b, tab3, cols2a, cols2b)),
        interpret=True, chan=True)).T
    lut2 = pack.lut2d_table(exp2d)
    lay = pack.t2_merge_layers(plan, lut2)
    assert lay.accept[1].any() and (lay.accept[0] != lay.accept[1]).any()
    got = kernels.t2_merged(*(torch.from_numpy(x) for x in (
        pack.lut2d_table3(lut2), lay.idx16, lay.cols, lay.accept,
        lay.rows))).numpy()
    assert np.array_equal(got >> 24, want >> 24)
    m = kernels._byte_mask(torch.from_numpy(want >> 24)).numpy()
    assert np.array_equal(got & m, want & m)
    assert ((want >> 24) == 7).any()     # both layers' channels on one pixel


def test_lut_pass_t2_merged_route_cpu_and_check_operands():
    """CPU tensors take the plain versions (no launch is counted); wrong
    dtype, shape or geometry raises before any kernel could see it."""
    rng = np.random.default_rng(8)
    _, tab, raw, cols, acc, rows = _pass_operands(rng, 12, 16, 10)
    t = [torch.from_numpy(x) for x in (tab, raw, cols, acc * 7, rows)]
    before = kernels.lut_pass.launches
    assert torch.equal(kernels.lut_pass(*t, 3, 4, 4, 4, 12, 16),
                       kernels.lut_pass_plain(*t, 3, 4, 4, 4, 12, 16))
    assert kernels.lut_pass.launches == before
    with pytest.raises(ValueError):
        kernels.lut_pass(*t, 3, 4, 4, 4, 8, 16)            # grid > image
    with pytest.raises(ValueError):
        kernels.lut_pass(*t, 3, 4, 4, 4, 12, 18)           # W % 4
    with pytest.raises(ValueError):
        kernels.lut_pass(*t, 3, 2, 4, 8, 12, 16)           # P != th * tw
    with pytest.raises(TypeError):
        kernels.lut_pass(*t[:4], t[4].to(torch.int64), 3, 4, 4, 4, 12, 16)
    ops = [torch.from_numpy(x) for x in _t3_operands(
        [_t3_layer(rng, 10, np.arange(10)) for _ in range(2)])]
    before = kernels.t2_merged.launches
    assert torch.equal(kernels.t2_merged(t[0], *ops),
                       kernels.t2_merged_plain(t[0], *ops))
    assert kernels.t2_merged.launches == before
    with pytest.raises(TypeError):
        kernels.t2_merged(t[0], *ops[:3], ops[3].to(torch.int64))


def _dict2p_d1(tab, t3ops, d1ops, H, W):
    """lut3d_vals_dict2p_d1 in interpret mode on the dictionary form of the
    port's operands (convert.to_jax_t3), relaid to image order."""
    d, idx4, cols2, tab3 = convert.to_jax_t3(tab, *t3ops)
    prm, codes4, wm2 = d1ops
    out = pk.lut3d_vals_dict2p_d1(
        *(jnp.asarray(x) for x in (idx4[0], idx4[1], tab3, cols2[0],
                                   cols2[1], codes4, prm, wm2)),
        interpret=True)
    return kernels.tile_to_image(torch.from_numpy(np.asarray(out).T.copy()),
                                 H // 4, W // 4).numpy()


def _t3_d1(tab, t3ops, d1ops, H, W):
    return kernels.t3_merged_d1(*(torch.from_numpy(np.ascontiguousarray(x))
                                  for x in (tab, *t3ops, *d1ops)),
                                H, W).numpy()


def _assert_written_channels_equal(got, want):
    """The per-channel written-bytes contract of lut3d_vals_dict2p_d1: flags
    (bits 24-26) equal everywhere, each value byte where its channel's flag
    is set (the Pallas kernel zeroes the T3 values of a lane block with no
    accepted tile, so unwritten bytes are not part of the result)."""
    assert np.array_equal(got >> 24, want >> 24)
    m = kernels._byte_mask(torch.from_numpy(want >> 24)).numpy()
    assert np.array_equal(got & m, want & m)


@pytest.mark.parametrize("name", ["img64", "img128"])
def test_t3_merged_d1_plain_vs_pallas_real(name):
    """t3_merged_d1_plain == lut3d_vals_dict2p_d1 (interpret mode) on a real
    fixture's merged T3 and 1D operands (pack.plan_to_args, the dictionary
    form through convert.to_jax_t3), under the written-channels contract;
    and == the split form's compose (t3_merged, then the 1D values winning
    where they write) on every written byte."""
    import pathlib

    from yaik_tpu.format import lut as lutmod
    fix = pathlib.Path(__file__).parent / "fixtures"
    expanded = lutmod.expand_lut(lutmod.parse_lut_file(
        (fix / "LutFile.lut").read_bytes()))
    plan = pack.plannermod.build_plan((fix / f"{name}.yaik").read_bytes(),
                                      expanded)
    lut = pack.lut_table(expanded)
    a = pack.plan_to_args(plan, lut)
    H, W = a.height, a.width
    t3ops = (a.idx16, a.cols, a.accept, a.rows)
    d1ops = (a.d1_prm, a.d1_codes4, a.d1_wm2)
    got = _t3_d1(lut.tab, t3ops, d1ops, H, W)
    assert got.shape == (H, W) and got.dtype == np.int32
    _assert_written_channels_equal(got, _dict2p_d1(lut.tab, t3ops, d1ops,
                                                   H, W))
    v3 = kernels.tile_to_image(torch.from_numpy(_t3_plain(lut.tab, *t3ops)),
                               H // 4, W // 4)
    v1 = kernels.tile_to_image(kernels.d1_block_vals(
        *(torch.from_numpy(x) for x in d1ops)), H // 4, W // 4)
    m1 = kernels._byte_mask((v1 >> 24) & 7)
    split = (v3 ^ ((v3 ^ v1) & m1)).numpy()
    m = kernels._byte_mask(torch.from_numpy(got >> 24)).numpy()
    assert np.array_equal(got & m, split & m)
    assert ((got >> 24) == 7).any() and (a.d1_wm2 != 0).any()


@pytest.mark.parametrize("H,W", [(16, 24), (40, 1288)])
def test_t3_merged_d1_plain_vs_pallas_random(H, W):
    """Random operands on ragged widths: tiles with max < min colours, a
    layer-A block set with no accepted tile, and pixels where only the 1D
    residual writes (some channels, or all)."""
    rng = np.random.default_rng(H + W)
    tab = _small_tab(rng)
    rows = rng.choice(tab.shape[0], 40, replace=False)
    G = (H // 4) * (W // 4)
    a = _t3_layer(rng, G, rows)
    a[2][: G // 3] = 0
    ops = _t3_operands([a, _t3_layer(rng, G, rows)])
    d1ops = d1_operands(rng, G)
    got = _t3_d1(tab, ops, d1ops, H, W)
    _assert_written_channels_equal(got, _dict2p_d1(tab, ops, d1ops, H, W))
    flags = got >> 24
    for f in (1, 2, 4, 3, 7):
        assert (flags == f).any()


def test_grad_plane_final_plain_vs_pallas():
    """grad_plane_final_plain == the Pallas grad_plane_final (interpret
    mode) with vc = v and mc = the byte mask of v's flags, including pixels
    where only one channel of v writes and pixels no gradient covers."""
    H, W = 64, 96
    accepts, corners, packed, code4 = _grad_operands(H, W, seed=23)
    rng = np.random.default_rng(23)
    v = (rng.integers(0, 1 << 24, (H, W))
         | (rng.integers(0, 8, (H, W)) << 24)).astype(np.int32)
    got = kernels.grad_plane_final(*(torch.from_numpy(x)
                                     for x in (packed, code4, v))).numpy()
    wy, bxc, r4y, r4x = je._grad_consts(H, W)
    corn = je._pack_grad_corners_host(np.stack(corners), H, W)
    mc = kernels._byte_mask(torch.from_numpy(v >> 24)).numpy()
    want = np.asarray(pk.grad_plane_final(
        jnp.asarray(corn), jnp.asarray(code4.astype(np.int32)), wy, bxc, r4y,
        r4x, jnp.asarray(v), jnp.asarray(mc), shifts=je.GRAD_SHIFTS,
        interpret=True))
    assert np.array_equal(got, want)
    assert (code4 == 0).any() and ((v >> 24) == 1).any()
    split = _blend_over_background(kernels.grad_plane(
        torch.from_numpy(packed), torch.from_numpy(code4)))
    assert np.array_equal(got, split ^ ((split ^ v) & mc))


def test_fused_wrappers_route_cpu_and_check_operands():
    """CPU tensors take the plain versions (no launch is counted); wrong
    dtype, shape or geometry raises before any kernel could see it."""
    accepts, corners, packed, code4 = _grad_operands(32, 32, seed=4)
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.integers(0, 1 << 27, (32, 32)).astype(np.int32))
    c, k = torch.from_numpy(packed), torch.from_numpy(code4)
    before = kernels.grad_plane_final.launches
    assert torch.equal(kernels.grad_plane_final(c, k, v),
                       kernels.grad_plane_final_plain(c, k, v))
    assert kernels.grad_plane_final.launches == before
    with pytest.raises(ValueError):
        kernels.grad_plane_final(c, k, v[:, :28].contiguous())
    with pytest.raises(TypeError):
        kernels.grad_plane_final(c, k, v.to(torch.int64))
    H, W = 8, 12
    G = (H // 4) * (W // 4)
    tab = torch.from_numpy(_small_tab(rng, 10))
    ops = [torch.from_numpy(x) for x in _t3_operands(
        [_t3_layer(rng, G, np.arange(10)) for _ in range(2)])]
    d1 = [torch.from_numpy(x) for x in d1_operands(rng, G)]
    before = kernels.t3_merged_d1.launches
    assert torch.equal(kernels.t3_merged_d1(tab, *ops, *d1, H, W),
                       kernels.t3_merged_d1_plain(tab, *ops, *d1, H, W))
    assert kernels.t3_merged_d1.launches == before
    with pytest.raises(ValueError):
        kernels.t3_merged_d1(tab, *ops, *d1, H, W + 4)         # G4 mismatch
    with pytest.raises(ValueError):
        kernels.t3_merged_d1(tab, *ops, *d1, H, W + 2)         # W % 4
    with pytest.raises(TypeError):
        kernels.t3_merged_d1(tab, *ops, d1[0].to(torch.int64), *d1[1:], H, W)
    with pytest.raises(ValueError):
        kernels.t3_merged_d1(tab, *ops, d1[0], d1[1][:, :1].contiguous(),
                             d1[2], H, W)
