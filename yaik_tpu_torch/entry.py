"""The port's entry point for harnesses: the counterpart of
`__graft_entry__.entry()`.

`entry(stream, lut, device="cuda")` returns `(fn, example_args)`:
`example_args` are the plan-time operands of the .yaik file `stream` on
`device` (planned by `decoder.planner.build_plan` against the LutFile
`lut`, packed by `decoder.pack.plan_to_args`, uploaded by
`decoder.engine.upload`) and the bank's `engine.Tables` on the same
device; `fn(*example_args)` runs `engine.decode_core` on them in the
default (split) form and returns the [h, w, 3] u8 pixels on that device.
`fn` plans, packs and uploads nothing, so a harness that times it times
the decode on the card alone. `__graft_entry__.entry()` decodes
`tests/fixtures/img128.yaik` with `tests/fixtures/LutFile.lut`; a caller
passes those paths for the same decode.

As every entry point of the port, it runs on the card unless the caller
asks for "cpu"; "cuda" on a machine without a card raises
(`engine.device_of`), and the operands are never built on the CPU instead.

The JAX package's `dryrun_multichip` (a decode and encode over an
n-device mesh) is not ported: the port runs on one card, and sharding over
several cards waits for a multi-card configuration that asks for it.
"""
from __future__ import annotations

import os
import pathlib

import torch

from yaik_tpu_torch.decoder import api, engine, pack, planner


def entry(stream: str | os.PathLike, lut: str | os.PathLike,
          device="cuda"):
    """(fn, example_args): the decode of the file `stream` on `device`."""
    dev = engine.device_of(device)
    bank = api.assign_lut(pathlib.Path(lut).read_bytes())
    tables = engine.Tables.build(bank.expanded, None, dev)
    plan = planner.build_plan(pathlib.Path(stream).read_bytes(),
                              bank.expanded)
    args = engine.upload(pack.plan_to_args(plan, tables.lut), dev)

    def fn(dargs: pack.DecodeArgs, tables: engine.Tables) -> torch.Tensor:
        return engine.decode_core(dargs, tables)

    return fn, (args, tables)
