"""The traffic generator: a closed loop of one caller around a driver's
entry point, driven by a traffic file's parameters.

A traffic file (`portbench/traffic/<name>.json`) names:

- `driver`: a module `portbench/drivers/<driver>.py`, found by name, that
  holds the entry point (see `load_driver`). The four the benchmark starts
  with are `decode_image`, `decode_corpus`, `encode_image` and
  `encode_corpus`, one file each; a later mix adds its own file.
- `per_call`: items a call takes, a number or `"all"` (the whole pool).
- `kwargs`: keywords the driver's entry point is called with (batch
  sizes, threads).
- `check_sample`: how many distinct inputs, drawn from the seed, have every
  answer compared with the reference (`"all"` for every one).

The seed fixes the order: the pool is walked in seeded permutations, a new
one each time it is used up, so every seed does the same work in another
order. A call's items are the next `per_call` of that walk.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import time
import traceback

import numpy as np

from portbench.reference.headers import FileHeader


@dataclasses.dataclass
class Call:
    t0: float                # perf_counter at the call
    t1: float                # perf_counter when its answers were on the host
    items: list              # pool indices, in call order
    ok: bool


@dataclasses.dataclass
class Inputs:
    """What a configuration hands the program: the committed streams, or
    the generated images; the LUT bank or 3D bank made from the
    benchmark's own files by the program's loaders; the pixels of each
    item, which may differ from item to item."""
    n: int
    pixels: list             # per item
    streams: list | None = None
    images: list | None = None
    lut: bytes | None = None
    lut_bank: object = None
    bank3d: object = None
    encoder_config: object = None


def load_driver(name: str, root: str):
    """`portbench/drivers/<name>.py`. A driver defines

    - `KIND`: `"decode"` or `"encode"`, the check its answers get
      (`harness.check`): decoded pixels against the reference decoder's,
      or streams against the reference encoder's;
    - `entry(inputs, device, **kwargs)`: a function of a list of pool
      indices that returns a list of answers, one per index;
    - optionally `inputs(cell)`: (the `Inputs`, the committed streams) of
      a configuration, where `pool_inputs` does not fit (other sizes,
      other content)."""
    path = os.path.join(root, "portbench", "drivers", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_driver_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if getattr(mod, "KIND", None) not in ("decode", "encode"):
        raise ValueError(f"driver {name!r}: KIND must be decode or encode")
    return mod


def pool_inputs(cell, kind: str) -> tuple:
    """(Inputs, the committed streams) of a configuration with a committed
    pool: the decode drivers get the streams (each item's pixels read from
    its header) and the LUT, the encode drivers the configuration's images
    (`gen.images`) and the 3D bank."""
    cfg = cell.config
    pool_dir = os.path.join(cell.root, cfg["pool"])
    names = sorted(n for n in os.listdir(pool_dir) if n.endswith(".yaik"))
    streams = []
    for n in names:
        with open(os.path.join(pool_dir, n), "rb") as f:
            streams.append(f.read())
    if kind == "decode":
        import yaik_tpu_torch
        heads = [FileHeader.unpack(s) for s in streams]
        inputs = Inputs(n=len(streams), streams=streams,
                        pixels=[h.width * h.height for h in heads])
        with open(os.path.join(cell.root, cfg["lut"]), "rb") as f:
            inputs.lut = f.read()
        inputs.lut_bank = yaik_tpu_torch.assign_lut(inputs.lut)
    else:
        from portbench.gen import images
        from yaik_tpu_torch.encoder import bank, context
        imgs = images.config_images(cfg)
        inputs = Inputs(n=len(imgs), images=imgs,
                        pixels=[im.shape[0] * im.shape[1] for im in imgs])
        inputs.bank3d = bank.load_bank(os.path.join(cell.root,
                                                    cfg["bank3d"]))
        inputs.encoder_config = context.EncoderConfig(**cfg["encoder"])
    return inputs, streams


class Order:
    """The seeded walk over the pool."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.queue: list = []

    def take(self, k: int) -> list:
        out = []
        while len(out) < k:
            if not self.queue:
                self.queue = [int(i) for i in self.rng.permutation(self.n)]
            out.append(self.queue.pop(0))
        return out


def run_window(fn, per_call: int, order: Order, seconds: float,
               keep: set, log) -> tuple:
    """Call `fn` on the next `per_call` items until `seconds` have passed
    since the first call began; the last call runs to its end. Returns
    (calls, {pool index: [answers]} for the indices in `keep`, window
    seconds from the first call to the end of the last)."""
    calls: list = []
    kept: dict = {}
    t_start = time.perf_counter()
    while True:
        idx = order.take(per_call)
        t0 = time.perf_counter()
        try:
            out = fn(idx)
            ok = True
        except Exception:                       # a failed request is counted
            out, ok = [], False
            if not any(not c.ok for c in calls):
                log(traceback.format_exc())
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, idx, ok))
        for j, i in enumerate(idx):
            if i in keep:
                kept.setdefault(i, []).append(out[j] if j < len(out)
                                              else None)
        if t1 - t_start >= seconds:
            return calls, kept, t1 - t_start
