"""The bench's two hooks in the port against the JAX package's, on the
CPU: `decoder.engine.salt_d1_color0` (`jax_engine.salt_d1_color0`, the
salted decode chain's perturbation of the 1D params) and
`format.headers.normalize_stream` (`yaik_tpu.format.headers`, the zeroing
of the reference encoder's two uninitialized header bytes). Exact
comparisons throughout (integers).
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yaik_tpu_torch
from yaik_tpu.decoder import jax_engine as je
from yaik_tpu.decoder import planner as jax_planner
from yaik_tpu.format.headers import normalize_stream as jax_normalize
from yaik_tpu_torch.decoder import engine, pack, planner
from yaik_tpu_torch.format.headers import normalize_stream

FIX = pathlib.Path(__file__).parent / "fixtures"
FIXTURES = sorted(p.name for p in FIX.glob("*.yaik"))
SALTS = [1, 255, 256]


def _packed(rng, lead: tuple, G: int) -> np.ndarray:
    """Random packed d1 params [*lead, 5, G] i32 (every bit random, bit 31
    and the unused top byte of row 0 included)."""
    return rng.integers(-(1 << 31), 1 << 31, (*lead, 5, G)).astype(np.int32)


def _jax_salt(prm: np.ndarray, s: int) -> np.ndarray:
    return np.asarray(je.salt_d1_color0(jnp.asarray(prm), jnp.int32(s)))


@pytest.mark.parametrize("s", SALTS)
def test_salt_equals_the_jax_hook(s):
    prm = _packed(np.random.default_rng(s), (), 96)
    got = engine.salt_d1_color0(torch.from_numpy(prm), s)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _jax_salt(prm, s))
    assert np.array_equal(prm, _packed(np.random.default_rng(s), (), 96))


@pytest.mark.parametrize("s", SALTS)
def test_salt_on_a_stacked_batch_equals_the_jax_hook(s):
    """The port's batch is [5, B, G4] (`stack_args`), the JAX package's
    [B, 5, G4]; a tensor salt salts alike."""
    prm = _packed(np.random.default_rng(100 + s), (4,), 64)
    want = _jax_salt(prm, s).transpose(1, 0, 2)
    rows_first = torch.from_numpy(np.ascontiguousarray(prm.transpose(1, 0, 2)))
    for salt in (s, torch.tensor(s, dtype=torch.int32)):
        got = engine.salt_d1_color0(rows_first, salt)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [0, 1, 7, 200, 255, 256])
def test_salt_model(s):
    """Each channel's color0 byte goes up by s mod 256; the base and
    delta2 rows stay (tests/test_round3_fastpaths.py's model)."""
    rng = np.random.default_rng(37)
    G = 64
    c0 = rng.integers(0, 256, (3, G)).astype(np.uint32)
    base = rng.integers(0, 256, (3, G)).astype(np.uint32)
    d2 = rng.integers(0, 1 << 21, (3, G)).astype(np.uint32)
    prm = np.stack([c0[0] | (c0[1] << 8) | (c0[2] << 16),
                    base[0] | (base[1] << 8) | (base[2] << 16),
                    d2[0], d2[1], d2[2]]).view(np.int32)
    got = engine.salt_d1_color0(torch.from_numpy(prm), s).numpy()
    cs = (c0 + s) & 0xFF
    assert np.array_equal(got[0].view(np.uint32),
                          cs[0] | (cs[1] << 8) | (cs[2] << 16))
    assert np.array_equal(got[1:], prm[1:])


def test_salted_decode_equals_the_jax_salted_decode():
    """img128 at s = 1: the port's decode_core on operands salted by the
    port's hook equals jax_engine.decode_core on plan_to_device_args
    operands salted by the JAX hook (slot 7), and differs from the
    unsalted decode."""
    stream = (FIX / "img128.yaik").read_bytes()
    bank = yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())
    shifts, tab, jargs = je.plan_to_device_args(
        jax_planner.build_plan(stream, bank.expanded), bank.expanded)
    jargs = list(jargs)
    jargs[7] = je.salt_d1_color0(jnp.asarray(jargs[7]), jnp.int32(1))
    want = np.asarray(je.decode_core(shifts, tab, *jargs))
    tables = engine.Tables.build(bank.expanded, None, "cpu")
    args = engine.upload(pack.plan_to_args(
        planner.build_plan(stream, bank.expanded), tables.lut), "cpu")
    args = dataclasses.replace(
        args, d1_prm=engine.salt_d1_color0(args.d1_prm, 1))
    salted = engine.decode_core(args, tables).numpy()
    assert np.array_equal(salted, want)
    assert not np.array_equal(salted, np.load(FIX / "img128.dec.npz")["rgb"])


@pytest.mark.parametrize("name", FIXTURES)
def test_normalize_stream_equals_the_jax_hook(name):
    stream = (FIX / name).read_bytes()
    got = normalize_stream(stream)
    assert got == jax_normalize(stream)
    assert len(got) == len(stream)
