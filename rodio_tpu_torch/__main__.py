"""Command-line surface: ``python -m rodio_tpu_torch <cmd>`` (rodio_tpu/__main__.py).

  python -m rodio_tpu_torch play FILE [--seconds S] [--volume V] [--speed R]
  python -m rodio_tpu_torch render FILE OUT.wav [--rate HZ] [--low-pass HZ]
      [--agc] [--limit] [--seconds S]
  python -m rodio_tpu_torch probe FILE            # format and duration
  python -m rodio_tpu_torch devices               # output backends

``play``, ``render`` and ``probe`` run on the current CUDA device, and
raise where there is none, unless given ``--device cpu``. ``render
--agc`` runs ``AutomaticGainControl(mode="pallas")`` on the card (its
kernels, K8 and K7) and ``mode="exact"`` on the CPU: the JAX package's
CLI takes ``"exact"`` everywhere, and the port's exact node is a
per-sample loop of torch ops, too slow on the card at any real length.
The two agree within 1e-6.
"""
from __future__ import annotations

import argparse
import sys
import time


def _build_chain(args):
    from rodio_tpu_torch.io.decoder import Decoder

    node = Decoder(args.file, device=args.device)
    if getattr(args, "seconds", None):
        node = node.take_duration(args.seconds)
    return node


def cmd_play(args) -> int:
    from rodio_tpu_torch.io.device import DeviceSinkBuilder, play

    sink = DeviceSinkBuilder(device=args.device).prefer_buffer_duration(0.05).open()
    player = play(sink, _build_chain(args))
    if args.volume != 1.0:
        player.set_volume(args.volume)
    if args.speed != 1.0:
        player.set_speed(args.speed)
    try:
        sink.start()
        while not player.empty():
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        sink.close()
    return 0


def render_chain(node, *, rate=None, low_pass=None, agc=False, limit=False):
    """``render``'s graph on ``node``: Resample to ``rate``, a 2nd-order
    low-pass at ``low_pass`` Hz (Q 0.5), the AGC (``"pallas"`` on the card,
    ``"exact"`` on the CPU) and the limiter, each where asked."""
    from rodio_tpu_torch.conversions.resample import Resample
    from rodio_tpu_torch.effects.agc import AgcSettings, AutomaticGainControl
    from rodio_tpu_torch.effects.blt import BltFilter
    from rodio_tpu_torch.effects.limit import Limit, LimitSettings

    if rate and rate != node.spec.sample_rate:
        node = Resample(node, rate)
    if low_pass:
        node = BltFilter(node, "low_pass", low_pass, 0.5, mode="auto")
    if agc:
        mode = "exact" if node.device.type == "cpu" else "pallas"
        node = AutomaticGainControl(node, AgcSettings(), mode=mode)
    if limit:
        node = Limit(node, LimitSettings(), mode="auto")
    return node


def cmd_render(args) -> int:
    from rodio_tpu_torch.io.wav import wav_to_file

    node = render_chain(_build_chain(args), rate=args.rate, low_pass=args.low_pass,
                        agc=args.agc, limit=args.limit)
    wav_to_file(node, args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_probe(args) -> int:
    from rodio_tpu_torch.io.decoder import Decoder

    node = Decoder(args.file, device=args.device)
    spec = node.spec
    frames = node.total_frames()
    dur = frames / spec.sample_rate if frames is not None else None
    print(f"file:      {args.file}")
    print(f"channels:  {spec.channels}")
    print(f"rate:      {spec.sample_rate} Hz")
    print(f"frames:    {frames if frames is not None else 'unknown'}")
    if dur is not None:
        print(f"duration:  {dur:.6f} s")
    print(f"device:    {node.device}")
    return 0


def cmd_devices(_args) -> int:
    from rodio_tpu_torch.io import alsa, pulse

    rows = [("alsa", alsa.available()), ("pulse", pulse.available()),
            ("null/file/callback", True)]
    for name, ok in rows:
        print(f"{name:20s} {'available' if ok else 'unavailable'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rodio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = ("'cuda' (the default: the current CUDA device; raises without "
                   "one), 'cuda:N' or 'cpu'")

    p = sub.add_parser("play", help="decode FILE and play to the OS sink")
    p.add_argument("file")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--volume", type=float, default=1.0)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("render", help="decode FILE through an effects "
                                      "chain to OUT.wav (offline)")
    p.add_argument("file")
    p.add_argument("out")
    p.add_argument("--rate", type=int, default=None)
    p.add_argument("--low-pass", type=float, default=None, dest="low_pass")
    p.add_argument("--agc", action="store_true",
                   help="automatic gain control: mode 'pallas' (its CUDA kernels) "
                        "on the card, 'exact' with --device cpu; within 1e-6")
    p.add_argument("--limit", action="store_true")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("probe", help="print FILE's decoded format")
    p.add_argument("file")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("devices", help="report the output backends")
    p.set_defaults(fn=cmd_devices)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
