"""The port's entry point (`yaik_tpu_torch.entry.entry`), the counterpart
of `__graft_entry__.entry()`: given img128's stream and LutFile.lut,
`fn(*example_args)` decodes img128 from its plan-time operands, exactly equal to `tests/fixtures/img128.dec.npz`
(tolerance 0: the codec is bit-exact), without planning, packing or
uploading anything itself. On the CPU when asked for; without a card the
default raises. The card's case is marked `cuda` and skips without one.
This file imports no jax, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_entry.py -q --noconftest
"""
import pathlib

import numpy as np
import pytest
import torch

from yaik_tpu_torch import entry as entrymod
from yaik_tpu_torch.decoder import engine, pack, planner

FIX = pathlib.Path(__file__).parent / "fixtures"


def _entry(*device):
    return entrymod.entry(FIX / "img128.yaik", FIX / "LutFile.lut", *device)


def _golden():
    return np.load(FIX / "img128.dec.npz")["rgb"]


def test_entry_on_the_cpu_equals_the_golden():
    fn, args = _entry("cpu")
    out = fn(*args)
    assert out.device.type == "cpu"
    assert out.dtype == torch.uint8 and tuple(out.shape) == (128, 128, 3)
    assert np.array_equal(out.numpy(), _golden())


def test_fn_plans_packs_and_uploads_nothing(monkeypatch):
    fn, args = _entry("cpu")

    def refuse(*a, **k):
        raise AssertionError("fn did host work")
    for mod, name in ((planner, "build_plan"), (pack, "plan_to_args"),
                      (engine, "upload")):
        monkeypatch.setattr(mod, name, refuse)
    assert np.array_equal(fn(*args).numpy(), _golden())


def test_example_args_are_on_the_device_asked_for():
    args, tables = _entry("cpu")[1]
    arrays = []
    args.map(arrays.append)
    assert arrays and all(a.device.type == "cpu" for a in arrays)
    assert tables.tab.device.type == "cpu"
    assert args.idx16 is not None and args.t3_passes is None  # merged T3


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: entry() runs on it")
def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="is_available"):
        _entry()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA GPU: torch.cuda.is_available() "
                           "is False")
def test_entry_on_the_card_equals_the_golden():
    fn, args = _entry()
    out = fn(*args)
    assert out.device.type == "cuda"
    assert np.array_equal(out.cpu().numpy(), _golden())
