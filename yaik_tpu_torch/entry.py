"""The port's entry points for harnesses: the counterparts of
`__graft_entry__.entry()` and `__graft_entry__.dryrun_multichip()`.

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

`dryrun_multichip(n_devices, devices=None)` runs the JAX package's seven
multi-device axes over a list of `n_devices` torch devices (default
`parallel.batch.data_devices(n_devices)`, the first n cards; a list may
name one card more than once, and `["cpu"] * n` runs the split on the
CPU): data-parallel decode of img64 x n against its golden; `img512` in
n bands; an RGBA batch, alpha decoded on the device, against the host
decoder; a 2DTL batch (`corr2d128.2d.yaik` with `LutFile2D.lut`); the
mixed-size 8-stream corpus in batches of n; the encode-scoring blob of n
64x64 images split over the devices, bit for bit the unsplit dispatch's;
and `encode_image_banded_mesh` of img128 in n bands, byte for byte the
host engine's `encode_image`. It prints one line per axis and returns,
for each axis, each device's kernel launches in it. The JAX version's
subprocess exists only to get a virtual CPU mesh; here every axis runs in
the calling process. Any mismatch raises.
"""
from __future__ import annotations

import os
import pathlib

import torch

from yaik_tpu_torch.decoder import api, engine, pack, planner
from yaik_tpu_torch.ops import kernels

FIX = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures"


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


_KERNELS = ("grad_plane", "grad_plane_final", "t3_merged", "t3_merged_d1",
            "t2_merged", "lut_pass", "grad_score", "score48", "score48_mode",
            "values48")


def _launches() -> dict:
    """Each device's launches of each kernel so far: {device: {name: n}}."""
    out: dict = {}
    for name in _KERNELS:
        for dev, k in getattr(kernels, name).per_device.items():
            out.setdefault(str(dev), {})[name] = k
    return out


def _since(before: dict) -> dict:
    """The launches since `before` (a `_launches()`), zeros left out."""
    out: dict = {}
    for dev, counts in _launches().items():
        for name, k in counts.items():
            k -= before.get(dev, {}).get(name, 0)
            if k:
                out.setdefault(dev, {})[name] = k
    return out


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The JAX package's multi-device dryrun over `devices` (see the module
    docstring): {axis: {device: {kernel: launches}}}."""
    import numpy as np
    from PIL import Image

    from yaik_tpu_torch.decoder import reference
    from yaik_tpu_torch.encoder import api as encapi
    from yaik_tpu_torch.encoder import bank as bankmod
    from yaik_tpu_torch.encoder import batch as ebatch
    from yaik_tpu_torch.encoder import pipeline
    from yaik_tpu_torch.encoder.context import EncoderConfig
    from yaik_tpu_torch.encoder.tables import device_tables
    from yaik_tpu_torch.parallel import batch as par

    devs = (par.data_devices(n_devices) if devices is None
            else engine.devices_of(engine.CARD, devices))
    if len(devs) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) got {len(devs)} "
                         "devices")
    n = n_devices
    where = f"over {n} devices [{', '.join(map(str, devs))}]"
    tag = f"dryrun_multichip({n})"
    per_axis: dict = {}

    def axis(name: str, ok: bool, what: str, before: dict) -> None:
        per_axis[name] = _since(before)
        if not ok:
            raise AssertionError(f"{tag}: {name} mismatch")
        print(f"{tag}: {name} OK, {what} {where}")

    def golden(name: str) -> np.ndarray:
        return np.load(FIX / f"{name}.dec.npz")["rgb"]

    lut_bytes = (FIX / "LutFile.lut").read_bytes()
    bank = api.assign_lut(lut_bytes)
    bank3d = bankmod.load_bank(str(FIX / "Bank3D"))

    # 1: data parallelism, a batch of img64 split over the devices
    before = _launches()
    got = par.decode_batch([(FIX / "img64.yaik").read_bytes()] * n, bank,
                           devices=devs)
    axis("DP", got.shape[0] == n and all(
        np.array_equal(g, golden("img64")) for g in got),
        f"batch decode {got.shape}", before)

    # 2: spatial sharding, img512 in n bands, one a device
    before = _launches()
    got = par.decode_spatial((FIX / "img512.yaik").read_bytes(), bank,
                             devices=devs)
    axis("spatial", np.array_equal(got, golden("img512")), f"{n} bands",
         before)

    # 3: an RGBA batch, alpha (ALPM + MIPM) decoded on the device
    yy, xx = np.mgrid[0:64, 0:64]
    rgba = np.stack([(yy * 3) & 0xFF, (xx * 3) & 0xFF,
                     ((yy + xx) * 2) & 0xFF,
                     np.where((yy >= 16) & (xx >= 16), (yy * 4) % 256, 0)],
                    axis=2).astype(np.uint8)
    st_a = encapi.encode_image(rgba, bank3d, device=devs[0])
    want = reference.decode(st_a, bank.expanded)
    before = _launches()
    got = par.decode_batch([st_a] * n, bank, devices=devs)
    axis("RGBA", got.shape[3] == 4 and all(
        np.array_equal(g, want) for g in got), "device alpha", before)

    # 4: a 2DTL (plane-pair LUT) batch
    st_2d = (FIX / "corr2d128.2d.yaik").read_bytes()
    bank2 = api.assign_lut(lut_bytes, (FIX / "LutFile2D.lut").read_bytes())
    want = reference.decode(st_2d, bank2.expanded, bank2.expanded2d)
    before = _launches()
    got = par.decode_batch([st_2d] * n, bank2, devices=devs)
    axis("2DTL", all(np.array_equal(g, want) for g in got),
         "batch decode", before)

    # 5: a mixed-size corpus, each batch split over the devices
    names = ["img64", "img128", "img512", "img128", "img64", "img64",
             "img128", "img64"]
    before = _launches()
    outs = par.decode_corpus([(FIX / f"{m}.yaik").read_bytes()
                              for m in names], bank, batch_size=n,
                             devices=devs)
    axis("corpus", all(np.array_equal(o, golden(m))
                       for o, m in zip(outs, names)),
         "mixed sizes in batches of n", before)

    # 6: the encode-scoring blob of n images split over the devices, bit
    # for bit the unsplit dispatch's on the first device
    cfg = EncoderConfig()
    caps = pipeline.pass_caps(64, 64)
    imgs = [np.ascontiguousarray(np.roll(rgba[:, :, :3], 8 * i, axis=1))
            for i in range(n)]
    want = ebatch._dispatch_batch(
        list(range(n)), imgs, cfg, device_tables(bank3d, devs[0]), caps,
        pipeline.scan_perms(64, 64, devs[0])).wait()
    before = _launches()
    jobs = ebatch._dispatch_split(par.split(list(range(n)), n), imgs, cfg,
                                  ebatch._device_states(bank3d, devs, 64, 64),
                                  caps)
    got = np.concatenate([j.wait() for j in jobs])
    axis("encode-scoring DP", np.array_equal(got, want),
         f"blob {got.shape} split", before)

    # 7: spatial encode, img128 in n bands, one a device
    big = np.asarray(Image.open(FIX / "img128.png").convert("RGB"))
    before = _launches()
    st_m = ebatch.encode_image_banded_mesh(big, bank3d, devices=devs)
    axis("spatial encode", st_m == encapi.encode_image(big, bank3d,
                                                       engine="host"),
         f"{n} bands, byte-identical", before)
    return per_axis
