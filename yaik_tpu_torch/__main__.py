"""yaik_tpu_torch command line: the port's counterpart of `python -m
yaik_tpu`, with the same subcommands and arguments. `--engine device|host`
(encode, decode, mine, mine-report, roundtrip) chooses the engine: device
(the default) runs the hand kernels on `--device cuda|cpu` (default cuda:
the card; cpu runs their plain versions; `cuda` without a card fails, it
never falls back); host runs the numpy host engines (the reference decoder,
the host scorer, the host miner), where `--device` plays no part. The JAX
command line's `decode --engine jax` is `--engine device` here.
`mine-report --engine host` mines on the host; its corpus encode
(`encode_corpus`) is device-only and runs on `--device`.

  python -m yaik_tpu_torch encode  img.png out.yaik  [--bank DIR] [--engine device|host] [--device cuda|cpu] [--stats]
  python -m yaik_tpu_torch decode  in.yaik out.png   [--lut FILE] [--engine device|host] [--device cuda|cpu] [--t3-d1] [--grad-final]
  python -m yaik_tpu_torch lut     bank_dir out.lut            (build LutFile.lut)
  python -m yaik_tpu_torch stats   in.yaik                     (per-technique report)
  python -m yaik_tpu_torch mine    out_dir imgs...  [--mode 2d] (LUT-bank mining)
  python -m yaik_tpu_torch mine-report out_dir imgs... (mine + corpus bpp/PSNR
                                  report vs a baseline bank, one command)
  python -m yaik_tpu_torch roundtrip img.png                   (encode+decode+PSNR)

`--trace DIR` (encode, decode) writes a torch.profiler trace to
DIR/trace.json; `--profile` prints the host spans (total, self time and
count by stage) and the transfer and zstd counters.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import time

import numpy as np

DEFAULT_FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"


def _load_bank(path):
    from yaik_tpu_torch.encoder import bank as bankmod
    bank = bankmod.load_bank(str(path))
    if bank.count == 0:
        sys.exit(f"no bank files found in {path}")
    return bank


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path))


def _maybe_trace(args):
    """The port's torch.profiler trace of the card (or the CPU: the host
    engine, or `--device cpu`), if asked for."""
    if not getattr(args, "trace", None):
        return contextlib.nullcontext()
    from yaik_tpu_torch.utils import profiler
    return profiler.device_trace(
        args.trace, "cpu" if args.engine == "host" else args.device)


def cmd_encode(args):
    from yaik_tpu_torch.encoder.api import EncoderConfig, encode_image
    bank = _load_bank(args.bank)
    img = _png(args.input)
    cfg = EncoderConfig(enable_single_color=args.enable_single_color,
                        enable_2d=args.enable_2d)
    bank2d = None
    if args.enable_2d:
        from yaik_tpu_torch.encoder import bank2d as bank2dmod
        bank2d = bank2dmod.load_bank2d(str(args.bank2d))
        if bank2d.count == 0:
            sys.exit(f"no Bank2D patterns found in {args.bank2d}")
    from yaik_tpu_torch.utils import profiler
    prof = profiler.enable() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof as profile, _maybe_trace(args):
        stream = encode_image(img, bank, device=args.device, config=cfg,
                              bank2d=bank2d, engine=args.engine)
    dt = time.perf_counter() - t0
    pathlib.Path(args.output).write_bytes(stream)
    h, w = img.shape[:2]
    print(f"{args.input}: {w}x{h} -> {len(stream)} B "
          f"({len(stream)*8/(w*h):.3f} bpp) in {dt:.2f}s")
    from yaik_tpu_torch.utils.stats import accumulate_global, analyze
    st = analyze(stream)
    # the reference always writes <out>.yaik.log.txt (EncoderContext.cpp:9480)
    pathlib.Path(args.output + ".log.txt").write_text(st.summary() + "\n")
    if args.global_stats:
        acc = accumulate_global(args.global_stats, st)
        print(f"global: {acc['images']} images, {acc['bpp']:.3f} bpp "
              f"({args.global_stats})")
    if args.stats:
        print(st.summary())
    if args.profile:
        print(profiler.report(profile))


def cmd_decode(args):
    from PIL import Image
    from yaik_tpu_torch.decoder import api
    stream = pathlib.Path(args.input).read_bytes()
    lut2d = (pathlib.Path(args.lut2d).read_bytes()
             if args.lut2d else None)
    lut = api.assign_lut(pathlib.Path(args.lut).read_bytes(), lut2d)
    from yaik_tpu_torch.utils import profiler
    prof = profiler.enable() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof as profile, _maybe_trace(args):
        img = api.decode_image(stream, lut, device=args.device,
                               t3_d1=args.t3_d1, grad_final=args.grad_final,
                               engine=args.engine)
    dt = time.perf_counter() - t0
    Image.fromarray(img).save(args.output)
    print(f"{args.input}: {img.shape[1]}x{img.shape[0]}"
          f"{'+A' if img.shape[2] == 4 else ''} in {dt:.2f}s -> {args.output}")
    if args.profile:
        print(profiler.report(profile))


def cmd_lut(args):
    if args.mode == "2d":
        from yaik_tpu_torch.encoder import bank2d as bank2dmod
        bank = bank2dmod.load_bank2d(args.bank_dir)
        data = bank2dmod.write_lut2d_file(bank)
    else:
        from yaik_tpu_torch.encoder import bank as bankmod
        bank = _load_bank(args.bank_dir)
        data = bankmod.write_lut_file(bank)
    pathlib.Path(args.output).write_bytes(data)
    print(f"{bank.count} tables -> {args.output} ({len(data)} B)")


def cmd_mine(args):
    from PIL import Image
    from yaik_tpu_torch.encoder import mining
    imgs = [np.asarray(Image.open(p).convert("RGB")) for p in args.images]
    if args.mode == "2d":
        n, total = mining.mine_bank2d(imgs, args.out_dir,
                                      max_tables=args.max_tables,
                                      device=args.device, engine=args.engine)
    else:
        n, total = mining.mine_bank(imgs, args.out_dir,
                                    max_tables=args.max_tables,
                                    checkpoint=args.checkpoint,
                                    device=args.device, engine=args.engine)
    print(f"{n} bank tables from {total} captured tiles -> {args.out_dir}")


def cmd_stats(args):
    from yaik_tpu_torch.utils.stats import analyze
    stream = pathlib.Path(args.input).read_bytes()
    st = analyze(stream)
    print(st.to_json() if args.json else st.summary())


def cmd_mine_report(args):
    """Close the research loop with a RESULT (the reference's
    capture + evaluateLUT workflow exists to minimize file size,
    EncoderContext.cpp:6350-6433/:8904-8985 + README.md:108-161): mine a
    bank from the corpus, then encode the SAME corpus with the baseline
    bank and with the mined bank at IDENTICAL acceptance gates and report
    corpus bpp, PSNR, and per-technique pixel shares for both."""
    import json as _json

    from PIL import Image

    from yaik_tpu_torch.decoder import api
    from yaik_tpu_torch.encoder import bank as bankmod
    from yaik_tpu_torch.encoder import mining
    from yaik_tpu_torch.encoder.batch import encode_corpus
    from yaik_tpu_torch.utils.stats import analyze

    imgs = [np.asarray(Image.open(p).convert("RGB")) for p in args.images]
    n, total = mining.mine_bank(imgs, args.out_dir,
                                max_tables=args.max_tables,
                                checkpoint=args.checkpoint,
                                device=args.device, engine=args.engine,
                                max_candidates=args.max_candidates)
    print(f"mined {n} tables from {total} captured tiles -> {args.out_dir}")
    banks = {"baseline": _load_bank(args.bank),
             "mined": bankmod.load_bank(args.out_dir)}
    report = {"corpus_images": len(imgs),
              "captured_tiles": total, "mined_tables": n,
              "baseline_bank": str(args.bank), "mined_bank": args.out_dir,
              "gates": "reference defaults (gradient rejectFactor=3; 3D "
                       "max channel err<=5, <=3 violators/tile)",
              "banks": {}}
    for name, bank in banks.items():
        streams = encode_corpus(imgs, bank, batch_size=args.batch,
                                device=args.device)
        lut = api.assign_lut(bankmod.write_lut_file(bank))
        bits = px = 0
        mse_sum = 0.0
        tech = {"gradient": 0, "tile3d": 0, "residual_1d": 0}
        bitpx = {}
        for img, stream in zip(imgs, streams):
            h, w = img.shape[:2]
            bits += len(stream) * 8
            px += h * w
            dec = api.decode_image(stream, lut, device=args.device,
                                   engine=args.engine)
            mse_sum += float(((img[:, :, :3].astype(np.float64)
                               - dec[:, :, :3].astype(np.float64)) ** 2
                              ).mean())
            st = analyze(stream)
            tech["gradient"] += sum(st.gradient_pixels.values())
            tech["tile3d"] += sum(st.tile3d_pixels.values())
            tech["residual_1d"] += st.pixels_1d
            for b, v in st.tile3d_bit_pixels.items():
                bitpx[str(b)] = bitpx.get(str(b), 0) + v
        mse = mse_sum / len(imgs)
        report["banks"][name] = {
            "bpp": round(bits / px, 4),
            "psnr_db": round(10 * np.log10(255 ** 2 / mse), 3)
            if mse else None,
            "technique_pixel_share": {
                k: round(v / px, 4) for k, v in tech.items()},
            "tile3d_bit_pixels": bitpx,
        }
        print(f"{name}: {report['banks'][name]['bpp']} bpp, "
              f"PSNR {report['banks'][name]['psnr_db']} dB")
    base_bpp = report["banks"]["baseline"]["bpp"]
    mined_bpp = report["banks"]["mined"]["bpp"]
    report["bpp_delta_pct"] = round(100 * (mined_bpp - base_bpp)
                                    / base_bpp, 2)
    out = pathlib.Path(args.report)
    out.write_text(_json.dumps(report, indent=1))
    print(f"bpp delta (mined vs baseline): {report['bpp_delta_pct']:+.2f}%"
          f"  -> {out}")


def cmd_roundtrip(args):
    from yaik_tpu_torch.decoder import api
    from yaik_tpu_torch.encoder import bank as bankmod
    from yaik_tpu_torch.encoder.api import encode_image
    bank = _load_bank(args.bank)
    img = _png(args.input)
    stream = encode_image(img, bank, device=args.device, engine=args.engine)
    lut = api.assign_lut(bankmod.write_lut_file(bank))
    dec = api.decode_image(stream, lut, device=args.device,
                           engine=args.engine)
    rgb_in, rgb_out = img[:, :, :3].astype(float), dec[:, :, :3].astype(float)
    mse = np.mean((rgb_in - rgb_out) ** 2)
    psnr = 10 * np.log10(255 ** 2 / mse) if mse else float("inf")
    h, w = img.shape[:2]
    print(f"{args.input}: {len(stream)*8/(w*h):.3f} bpp  PSNR {psnr:.2f} dB")


def _device_arg(parser, what="the kernels"):
    parser.add_argument("--engine", default="device",
                        choices=["device", "host"],
                        help="device: the kernels on --device (the "
                             "default); host: the numpy host engine")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help=f"cuda: {what} on the card (the default; fails "
                             "without one); cpu: their plain versions")


def main(argv=None):
    p = argparse.ArgumentParser(prog="yaik_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode")
    e.add_argument("input"); e.add_argument("output")
    e.add_argument("--bank", default=DEFAULT_FIX / "Bank3D")
    _device_arg(e, "tile scoring")
    e.add_argument("--stats", action="store_true")
    e.add_argument("--enable-single-color", action="store_true",
                   help="UCOL pass (disabled in the reference, "
                        "EncoderContext.cpp:9036)")
    e.add_argument("--enable-2d", action="store_true",
                   help="2DTL plane-pair passes (disabled upstream)")
    e.add_argument("--bank2d", default=DEFAULT_FIX / "Bank2D")
    e.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler trace to DIR/trace.json "
                        "(view with Perfetto / chrome://tracing)")
    e.add_argument("--profile", action="store_true",
                   help="print per-stage host timings")
    e.add_argument("--global-stats", metavar="PATH", default=None,
                   help="accumulate corpus statistics across runs "
                        "(globalStats.bin analog, JSON)")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode")
    d.add_argument("input"); d.add_argument("output")
    d.add_argument("--lut", default=DEFAULT_FIX / "LutFile.lut")
    d.add_argument("--lut2d", default=None,
                   help="LutFile2D.lut for streams with 2DTL chunks")
    _device_arg(d, "the decode")
    d.add_argument("--t3-d1", action="store_true",
                   help="fused T3 + 1D kernel (t3_merged_d1) where the "
                        "stream qualifies (YAIK_T3_D1 in the JAX package)")
    d.add_argument("--grad-final", action="store_true",
                   help="fused final gradient kernel (grad_plane_final) "
                        "where the stream qualifies (YAIK_GRAD_FINAL)")
    d.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler trace to DIR/trace.json")
    d.add_argument("--profile", action="store_true",
                   help="print per-stage host timings")
    d.set_defaults(fn=cmd_decode)

    l = sub.add_parser("lut")
    l.add_argument("bank_dir"); l.add_argument("output")
    l.add_argument("--mode", default="3d", choices=["3d", "2d"],
                   help="2d builds a LutFile2D.lut from Bank2D PNGs")
    l.set_defaults(fn=cmd_lut)

    m = sub.add_parser("mine", help="mine a LUT bank from training images")
    m.add_argument("out_dir")
    m.add_argument("images", nargs="+")
    m.add_argument("--mode", default="3d", choices=["3d", "2d"])
    m.add_argument("--max-tables", type=int, default=12)
    m.add_argument("--checkpoint", default=None,
                   help="capture-phase checkpoint file (resumable)")
    _device_arg(m, "capture claims (3d) and coverage matrices")
    m.set_defaults(fn=cmd_mine)

    s = sub.add_parser("stats")
    s.add_argument("input")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_stats)

    mr = sub.add_parser(
        "mine-report",
        help="mine a bank AND report corpus bpp/PSNR vs a baseline bank "
             "at identical acceptance gates (one-command research loop)")
    mr.add_argument("out_dir")
    mr.add_argument("images", nargs="+")
    mr.add_argument("--bank", default=DEFAULT_FIX / "Bank3D",
                    help="baseline bank to beat")
    mr.add_argument("--report", default="mine_report.json")
    mr.add_argument("--max-tables", type=int, default=12)
    mr.add_argument("--max-candidates", type=int, default=256)
    mr.add_argument("--batch", type=int, default=8)
    mr.add_argument("--checkpoint", default=None)
    _device_arg(mr, "mining, encode and decode")
    mr.set_defaults(fn=cmd_mine_report)

    r = sub.add_parser("roundtrip")
    r.add_argument("input")
    r.add_argument("--bank", default=DEFAULT_FIX / "Bank3D")
    _device_arg(r, "encode and decode")
    r.set_defaults(fn=cmd_roundtrip)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
