"""Differential fuzz of the port's control plane against the refimpl oracle:
the port of ``tests/test_fuzz_control.py``.

The schedules are the original's (its ``_sample_cfg``, block sizes, op
mixes, sound contents on the 2^-12 grid and the aligned periodic and seek
positions, loaded from that file): random control ops at random block
boundaries run through the port's Player, queue and mixer on the CPU and
through ``rodio_tpu.refimpl``'s per-sample transcription of the
reference, and the audio must be bit-equal, with the same len / empty /
is_paused after every block and get_pos within 2.5 blocks. The alignment
rules and the zombie and double-skip windows are the original's (see its
``_run_knobs``). A failure shrinks to a minimal schedule.

Seeds 0, 1, 2, 3 and 5 run in the quick tier (2 and 5 are stitch-tier);
the other 51 are ``slow``, as in the original.
"""
from __future__ import annotations

import importlib.util
import sys
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import pytest

from rodio_tpu import refimpl as ri

_spec = importlib.util.spec_from_file_location(
    "_fuzz_control_schedules", Path(__file__).with_name("test_fuzz_control.py"))
_orig = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = _orig  # its dataclass resolves its module
_spec.loader.exec_module(_orig)
RATE, Cfg = _orig.RATE, _orig.Cfg


def _ref_block(src, B, C):
    ref = np.empty(B * C, np.float32)
    for i in range(B * C):
        v = src.next()
        ref[i] = 0.0 if v is None else v
    return ref.reshape(B, C).T


def _mismatch(blk, got, want) -> Optional[str]:
    if got.shape != want.shape:
        return f"block {blk}: shape {got.shape} vs {want.shape}"
    if not np.array_equal(got, want):
        d = np.abs(got - want)
        i = np.unravel_index(np.argmax(d), d.shape)
        return f"block {blk}: audio mismatch at {i}: {got[i]} vs {want[i]} (max dev {d.max():.3g})"
    return None


def _run_knobs(cfg: Cfg) -> Optional[str]:
    from rodio_tpu_torch.control.mixer import mixer as port_mixer
    from rodio_tpu_torch.control.player import Player
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    C, B = cfg.channels, cfg.block
    mh, msrc = port_mixer(C, RATE, device="cpu")
    bp = Player.connect_new(mh, block_frames=B)
    rh, rsrc = ri.mixer(C, RATE)
    rp = ri.Player(rh)
    rp.PERIODIC_NS = _orig._period_ns_for(B, C)

    by_block: dict = {}
    for b, op, arg in cfg.ops:
        by_block.setdefault(b, []).append((op, arg))
    n_append, zombie, sound_seen = 0, False, False
    for blk in range(cfg.n_blocks):
        skipped_this_block = False
        for op, arg in by_block.get(blk, []):
            if op in ("skip_one", "clear", "try_seek") and zombie:
                continue
            if op == "skip_one" and skipped_this_block:
                continue
            if op == "append":
                vals = _orig._source_values(cfg.seed * 977 + n_append, arg, C)
                n_append += 1
                bp.append(SamplesBuffer(C, RATE, vals.reshape(arg, C).T.copy(), device="cpu"))
                rp.append(ri.SamplesBuffer(C, RATE, vals))
            elif op == "pause":
                bp.pause(), rp.pause()
            elif op == "play":
                bp.play(), rp.play()
            elif op == "set_volume":
                bp.set_volume(arg / 64.0), rp.set_volume(arg / 64.0)
            elif op == "skip_one":
                bp.skip_one(), rp.skip_one()
                skipped_this_block = True
            elif op == "clear":
                bp.clear(), rp.clear()
            elif op == "stop":
                bp.stop(), rp.stop()
            elif op == "try_seek":
                if bp.len() > 0 and rp.len() > 0:
                    pos = arg / RATE
                    if int(pos * RATE) != arg:
                        pos = float(np.nextafter(pos, np.inf))
                    if int(pos * RATE) != arg:
                        continue
                    try:
                        bp.try_seek(pos)
                    except Exception as e:
                        return f"port try_seek raised {e!r}"
                    rp.try_seek(_orig._seek_ns_for(arg, C))
        blk_audio, _ = msrc.next_block(B)
        ref_audio = _ref_block(rsrc, B, C)
        if bp.len() > 0:
            zombie, sound_seen = False, True
        elif sound_seen:
            zombie = True
        msg = _mismatch(blk, blk_audio.numpy(), ref_audio)
        if msg:
            return msg
        if bp.len() != rp.len():
            return f"block {blk}: len {bp.len()} vs {rp.len()}"
        if bp.empty() != rp.empty():
            return f"block {blk}: empty {bp.empty()} vs {rp.empty()}"
        if bp.is_paused() != rp.is_paused():
            return f"block {blk}: is_paused {bp.is_paused()} vs {rp.is_paused()}"
        rpos, bpos = rp.get_pos_secs(), bp.get_pos()
        if rpos > 0.0 and bpos > 0.0 and abs(rpos - bpos) > 2.5 * B / RATE:
            return f"block {blk}: get_pos {bpos} vs {rpos}"
    return None


def _run_stitch(cfg: Cfg) -> Optional[str]:
    from rodio_tpu_torch.control.queue import queue as port_queue
    from rodio_tpu_torch.sources.generators import SamplesBuffer

    C, B = cfg.channels, cfg.block
    btx, brx = port_queue(True, block_frames=B, device="cpu")
    rtx, rrx = ri.queue(True)
    by_block: dict = {}
    for b, op, arg in cfg.ops:
        by_block.setdefault(b, []).append((op, arg))
    b_signals, r_signals = [], []
    n_append = 0
    for blk in range(cfg.n_blocks):
        for op, arg in by_block.get(blk, []):
            vals = _orig._source_values(cfg.seed * 977 + n_append, arg, C)
            n_append += 1
            b_signals.append(btx.append_with_signal(SamplesBuffer(
                C, RATE, vals.reshape(arg, C).T.copy(), device="cpu")))
            r_signals.append(rtx.append_with_signal(ri.SamplesBuffer(C, RATE, vals)))
        blk_audio, alive = brx.next_block(B)
        ref_audio = _ref_block(rrx, B, C)
        ba = blk_audio.numpy()
        if ba.shape[0] != C:
            # the format peek defaults to mono before the first sound and
            # after the last one drains: both sides must be silent then
            if ba.any() or ref_audio.any():
                return f"block {blk}: channel-mismatch block not silent"
        else:
            msg = _mismatch(blk, ba, ref_audio)
            if msg:
                return msg
        if not alive:
            return f"block {blk}: keep-alive queue reported dead"
        bs, rs = [s[0] for s in b_signals], [s[0] for s in r_signals]
        if bs != rs:
            return f"block {blk}: done signals {bs} vs {rs}"
    return None


def _check(cfg: Cfg) -> Optional[str]:
    return (_run_knobs if cfg.tier == "knobs" else _run_stitch)(cfg)


def _shrink(cfg: Cfg) -> Cfg:
    """Truncate to the failing block, then drop ops while it still fails."""
    cur = cfg
    for n in range(1, cur.n_blocks):
        cand = replace(cur, n_blocks=n, ops=tuple(o for o in cur.ops if o[0] < n))
        if _check(cand) is not None:
            cur = cand
            break
    changed = True
    while changed:
        changed = False
        for i in range(len(cur.ops)):
            cand = replace(cur, ops=cur.ops[:i] + cur.ops[i + 1:])
            if _check(cand) is not None:
                cur, changed = cand, True
                break
    return cur


def _run(seed: int) -> None:
    cfg = _orig._sample_cfg(seed)
    msg = _check(cfg)
    if msg is not None:
        small = _shrink(cfg)
        pytest.fail(f"control-plane fuzz {cfg.label()}: {msg}\n"
                    f"minimal failing config ({_check(small)}): {small.label()}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_fuzz_control_quick(seed):
    """The quick tier (seeds 2 and 5 stitch, the rest knobs)."""
    _run(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [4] + list(range(6, 56)))
def test_fuzz_control(seed):
    _run(seed)
