"""The port's RGBA decode (MIPM and ALPM planned on the host, the alpha
plane made on the device) and RGBA encode, held against the plain
reference on the eight RGBA fixtures and the five alpha cases, on the CPU
and (`cuda`) on the card:

    python -m pytest portbench/tests/test_portbench_alpha_port.py -q
    python -m pytest portbench/tests/test_portbench_alpha_port.py -q -m cuda -s

This file imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from rgba_inputs import (ALPHA_CASES, CASES, RGBA, ROOT, read_fixture,
                         read_lut, reference_bank, rgba_case)
from portbench.reference import canonical, decoder
from portbench.reference.context import EncoderConfig


@pytest.fixture(scope="module")
def lut() -> bytes:
    return read_lut()


def _port_cases(device: str, lut: bytes):
    """(fixture or case, the port's answer, the reference's) on `device`:
    the eight fixtures decoded, and the five alpha cases encoded (each
    stream in its canonical form)."""
    import yaik_tpu_torch
    from yaik_tpu_torch.encoder import bank as port_bank
    from yaik_tpu_torch.encoder import context as port_context
    from portbench.reference import encoder
    lut_bank = yaik_tpu_torch.assign_lut(lut)
    for name in RGBA:
        s = read_fixture(name)
        yield (name, yaik_tpu_torch.decode_image(s, lut_bank, device=device),
               decoder.decode(s, lut))
    b3 = port_bank.load_bank(os.path.join(ROOT, "portbench/data/Bank3D"))
    for case in CASES:
        kw = ALPHA_CASES[case][0]
        got = yaik_tpu_torch.encode_image(
            rgba_case(case), b3, device=device,
            config=port_context.EncoderConfig(**kw))
        yield (f"encode {case}", canonical.canonical(got),
               canonical.canonical(encoder.encode_image(
                   rgba_case(case), reference_bank(), EncoderConfig(**kw))))


def _same(got, want) -> bool:
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        return got.shape == want.shape and bool((got == want).all())
    return got == want


def test_port_on_the_cpu_equals_the_reference(lut):
    for name, got, want in _port_cases("cpu", lut):
        assert _same(got, want), name


@pytest.mark.cuda
def test_port_on_the_card_equals_the_reference(lut):
    """The port's RGBA decode (MIPM / ALPM planned on the host, the alpha
    plane made on the card) and RGBA encode, on the card, against the
    plain reference; prints one line a case."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bad = []
    for name, got, want in _port_cases("cuda", lut):
        ok = _same(got, want)
        if isinstance(want, np.ndarray):
            got = np.asarray(got)
            n = (int(np.count_nonzero(got != want))
                 if got.shape == want.shape else want.size)
            print(f"decode {name}: {want.shape} pixels_differing {n}, "
                  f"alpha values {np.unique(want[..., 3]).size}", flush=True)
        else:
            print(f"{name}: canonical form equal {ok}, chunks "
                  f"{[c[0].decode() for c in want[1:]]}", flush=True)
        if not ok:
            bad.append(name)
    assert not bad, bad
