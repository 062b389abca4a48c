"""Flagship workload: the 512-stream batched DSP pipeline (rodio_tpu/flagship.py).

BASELINE.json config 5: resample 44.1 -> 48 kHz, RBJ low-pass, per-stream
gain, mix and master limit for 512 concurrent stereo streams on one card.
The stream axis folds into the channel axis (512 stereo streams = one
1024-channel chain):

  SamplesBuffer[1024ch PCM @44.1k]
    -> FusedWidePipeline   (K1: resample + gain + biquad + mix -> [2, T])
    -> Limit               (K3: the blocked stereo master limiter)

and its parity partner, the unfused chain

  SamplesBuffer -> Resample -> BltFilter (K4) -> Amplify -> WideMixer -> Limit

(with ``block_bf16=True`` a Bf16Boundary after the Resample, and K4 on bf16
blocks). With the AGC on (``with_agc=True``: BASELINE config 5 with the config-2
AGC stage per stream), the fused node runs K2 (resample + biquad + AGC +
gain + mix; K2g, its group branch, with ``agc_group`` > 0; K2r or K2b
with a rel0 ``agc_plan``), and the unfused chain gains an
AutomaticGainControl (K6 with ``scan_mode="pallas"``) after the filter.
``make_flagship(512, scan_mode="fused", with_agc=True, agc_plan="rel0b16",
precision="int2")`` is the JAX package's AGC-on bench leg (``bench.py``'s
``agc_on``).

The JAX package's TPU schedule knobs (``lookahead``, ``subblk``,
``firfold``, ``ufir``, ``dma_depth``, ``m``, ``binary_mix``,
``inkernel_limit``) have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .conversions.resample import (
    Resample, drain_bookkeeping, lerp_weights, output_positions,
    resample_output_frames)
from .conversions.blockdtype import Bf16Boundary
from .core.node import Node, State, full_valid, mask_block
from .core.types import StreamSpec
from .core.math import duration_to_coefficient
from .core.types import duration_to_nanos
from .effects.agc import RMS_WINDOW_SIZE, AgcSettings, AutomaticGainControl
from .effects.basic import Amplify
from .effects.blt import BltFilter, blt_coefficients
from .effects.limit import Limit, LimitSettings
from .ops.fused import (
    AGC_REL0_PLANS, AGC_RING_FRAMES, fused_resample_biquad_agc_mix,
    fused_resample_biquad_mix, rel0_chunks)
from .parallel.batch import WideMixer
from .sources.generators import SamplesBuffer
from .utils.device import DeviceLike

PRECISIONS = ("auto", "highest", "int3", "int2", "i8", "i24")
#: the precisions whose PCM the JAX package splits into integer pieces
INT_PIECES = ("int3", "int2", "i8", "i24")


def _content_probe(input_node) -> tuple:
    """(int16_grid_exact, int24_grid_exact, two_piece_exact) of the node's
    PCM, in one device pass with one read-back, cached on the node."""
    data = getattr(input_node, "_data", None)
    if data is None:
        return (False, False, False)
    cached = getattr(input_node, "_content_probe_cache", None)
    if cached is not None:
        return cached
    s = data * 32768.0  # exact: a pure exponent shift in f32
    k = torch.round(s)
    g16 = ((s == k) & (k >= -32768.0) & (k <= 32767.0)).all()
    s24 = data * 8388608.0
    k24 = torch.round(s24)
    g24 = ((s24 == k24) & (k24 >= -8388608.0) & (k24 <= 8388607.0)).all()
    p1 = data.to(torch.bfloat16).to(data.dtype)
    r = data - p1
    tp = (r == r.to(torch.bfloat16).to(data.dtype)).all()
    res = torch.stack([g16, g24, tp]).cpu().tolist()  # one read-back
    out = (bool(res[0]), bool(res[1]), bool(res[2]))
    input_node._content_probe_cache = out
    return out


class _LerpTaps:
    """(left rows [n], lerp weights [n, 2]) of output frames o0 .. o0+n-1
    for K1. left(o0 + t) = (o0 // to)*from + left(o0 % to + t), so the rows
    and weights of each (o0 % to, n) are built once and a block costs one
    add."""

    def __init__(self, from_: int, to: int, device: torch.device):
        self.from_, self.to, self.device = from_, to, device
        # [to, 2]: the two lerp weights of each phase
        self._wtab = torch.from_numpy(
            np.stack(lerp_weights(from_, to), axis=1)).to(device)
        self._cache = {}

    def __call__(self, o0: int, n: int):
        key = (o0 % self.to, n)
        taps = self._cache.get(key)
        if taps is None:
            if len(self._cache) >= 8:
                self._cache.clear()
            left, phase = output_positions(key[0], n, self.from_, self.to,
                                           self.device)
            taps = self._cache[key] = (left, self._wtab.index_select(0, phase))
        return taps[0] + (o0 // self.to) * self.from_, taps[1]


class FusedWidePipeline(Node):
    """Resample + gain + biquad + stream mix in ONE kernel (K1; K2 with the
    AGC).

    Fuses the flagship's Resample -> BltFilter -> Amplify -> WideMixer
    chain so each block makes one pass over the input PCM. The upstream
    must be a random-access, sliceable source (a SamplesBuffer).

    Outputs match the unfused chain to ~1e-6 (the gain is applied before
    the biquad rather than after it, and the mix sums in another order),
    except the final drain frame of the stream, which the unfused resampler
    emits as the raw last input frame while the kernel resamples it with a
    zero right neighbour.

    ``precision`` accepts the JAX package's values and runs the same
    content probe; ``"i8"``/``"i24"`` on content off their sample grid
    raise. Every value stores the PCM as f32 here (narrower storage is a
    later change).

    ``with_agc=True`` (stereo streams) puts one AGC per stream
    (``agc_settings``, default ``AgcSettings()``) between the biquad and
    the mix, and applies the stream gains after it, as the JAX package
    does. Its state: per-stream carries ``agc`` [3, S] (rms_sum, peak,
    gain), the square-history ring ``ring`` [4096, lanes] (``agc_ring``
    "bf16" rounds each square to bf16 before it enters the window sum, the
    same value leaving it 4096 frames later; "f32" keeps f32), and the
    parameters ``agc_par`` as data, so :meth:`set_agc_params` rebuilds
    nothing. ``agc_plan`` "auto"/"serial" is the serial plan (K2), which
    serves every release time.

    The rel0 plans (``AGC_REL0_PLANS``) are the JAX package's schedules for
    a release time of 0, the default: built with any other release or with
    ``agc_group`` they raise, and so does a live nonzero release. ``rel0``
    and ``rel0f`` step sample by sample (K2r); ``rel0b*`` and ``rel0c*``
    compose the smoother within RPC chunks of each m*to-frame grid step
    (K2b), so RPC must divide m*to and every block must hold whole steps.
    All but ``rel0`` keep the ring in the packed basis: lane 2s holds the
    rounded square of channel 0, lane 2s+1 that of the sum of both
    channels' squares. The peak carry stays as it was.

    ``agc_group`` = AG > 0 is the JAX package's group-rate AGC (its
    AgcGroup contract, an opt-in that changes results): window sums, peaks
    and the gain smoother (with att^(2 AG), rel^(2 AG)) advance once per
    group of AG frames, the gain applied as a staircase (K2g). The ring then
    holds 4096 / AG rounded group sums per stream. AG takes the JAX
    package's values for the same rates and precision: >= 2, dividing the
    RMS lag 4096 and m*to, where m is the JAX pipeline's frames-per-step
    factor under the AGC (2, or 1 for to > 320 with an int-piece
    precision). Groups start at multiples of AG from the stream's start, so
    every block must hold whole groups, as the JAX pipeline's blocks of
    whole m*to steps do.
    """

    def __init__(self, input_node: Node, to_rate: int, gains, n_streams: int,
                 kind: str = "low_pass", freq: float = 2000.0, q: float = 0.5,
                 *, precision: str = "auto", with_agc: bool = False,
                 agc_settings: Optional[AgcSettings] = None,
                 agc_ring: str = "bf16", agc_group: int = 0,
                 agc_plan: str = "auto"):
        if not (getattr(input_node, "RANDOM_ACCESS", False)
                and hasattr(input_node, "slice_frames")):
            raise TypeError("FusedWidePipeline needs a sliceable random-access source")
        self.input = input_node
        self.device = input_node.device
        wide = input_node.spec.channels
        if wide % n_streams:
            raise ValueError("channel count not divisible by stream count")
        self.n_streams = n_streams
        C = wide // n_streams
        self.spec = StreamSpec(C, to_rate)
        from_rate = input_node.spec.sample_rate
        g = math.gcd(from_rate, to_rate)
        self.from_ = from_rate // g
        self.to = to_rate // g
        if self.from_ == self.to:
            raise ValueError("identity ratio: use the plain chain")
        self.precision = self._resolve_precision(precision)
        self._kind, self._freq, self._q = kind, float(freq), float(q)
        self.coeffs = blt_coefficients(kind, to_rate, freq, q).as_tuple()
        gains = np.asarray(gains, dtype=np.float32)
        per_lane = np.repeat(gains, C) if gains.shape == (n_streams,) else gains
        if per_lane.shape != (wide,):
            raise ValueError(f"gains must be [{n_streams}] or [{wide}]")
        self._gains = per_lane
        self._taps = _LerpTaps(self.from_, self.to, self.device)
        self._wide = wide
        self._s0 = getattr(input_node, "_start", 0)
        self.with_agc = bool(with_agc)
        if self.with_agc:
            self._init_agc(C, to_rate, agc_settings, agc_ring, agc_group,
                           agc_plan)

    def _init_agc(self, C, to_rate, settings, ring, group, plan):
        if C != 2:
            raise ValueError("the fused AGC supports stereo streams")
        if ring not in ("bf16", "f32"):
            raise ValueError(f"agc_ring must be 'bf16' or 'f32', got {ring!r}")
        # the JAX pipeline's frames per grid step under the AGC
        # (rodio_tpu/flagship.py:242-276): groups and rel0 chunks divide it
        self._mto = (1 if self.precision in INT_PIECES and self.to > 320
                     else 2) * self.to
        if group and (group < 2 or self._mto % group or AGC_RING_FRAMES % group):
            raise ValueError(
                f"agc_group {group} must be >= 2 and divide both m*to = "
                f"{self._mto} and the RMS lag {AGC_RING_FRAMES}")
        self._agc_group = int(group)
        if plan not in ("auto", "serial") + AGC_REL0_PLANS:
            raise ValueError(f"unknown agc_plan {plan!r}")
        st = settings or AgcSettings()

        def coeff(seconds):
            nanos = min(duration_to_nanos(seconds), 10_000_000_000)
            return float(duration_to_coefficient(0, to_rate, nanos=nanos))

        self._agc_params = (
            coeff(st.attack_time), coeff(st.release_time),
            float(np.float32(st.target_level)),
            float(np.float32(st.absolute_max_gain)), 0.0,
            float(np.float32(1.0) / np.float32(RMS_WINDOW_SIZE)))
        self._agc_ring = ring
        self._agc_plan = "serial" if plan == "auto" else plan
        if plan in AGC_REL0_PLANS:
            # the JAX package's refusals (rodio_tpu/flagship.py:407-411, and
            # its kernel's RPC | m*to)
            if self._agc_params[1] != 0.0 or group:
                raise ValueError(
                    f"agc_plan={plan!r} requires release_time=0 and no "
                    "agc_group")
            rpc = rel0_chunks(plan)
            if rpc and self._mto % rpc:
                raise ValueError(
                    f"agc_plan={plan!r} needs its {rpc} chunks to divide "
                    f"m*to = {self._mto}")

    def _resolve_precision(self, precision: str) -> str:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        if precision == "auto":
            if self.to > 1024:
                return "highest"
            g16, g24, tp2 = _content_probe(self.input)
            return "i8" if g16 else "i24" if g24 else "int2" if tp2 else "int3"
        if precision in ("i8", "i24"):
            if self.to > 1024:
                raise ValueError(f"precision={precision!r} needs to <= 1024")
            g16, g24, _ = _content_probe(self.input)
            if not (g16 if precision == "i8" else g24):
                grid = "int16 grid (k / 2^15)" if precision == "i8" else "int24 grid (k / 2^23)"
                raise ValueError(
                    f"precision={precision!r} needs content exactly on the "
                    f"{grid}; off-grid samples would be silently rounded")
        return precision

    def total_frames(self) -> Optional[int]:
        n_in = self.input.total_frames()
        if n_in is None:
            return None
        return resample_output_frames(n_in, self.from_, self.to)

    def init_state(self) -> State:
        in_state = self.input.init_state()
        # one-time restructure of the PCM: time-major [frames, lanes], so a
        # block's lerp reads whole rows; the upstream's copy is dropped
        pcm = in_state["data"][:, self._s0:].T.contiguous()
        in_state = {k: v for k, v in in_state.items() if k != "data"}
        dev = self.device
        return {
            "in": in_state,
            "pcm": pcm,
            "out_o": 0,  # host int: advances by n per emit
            "drained": torch.tensor(False, device=dev),
            "bq": torch.zeros((4, self._wide), dtype=torch.float32, device=dev),
            # coefficients and gains live in the state: the kernel reads
            # them as data, so a retune rebuilds nothing
            "coeffs": torch.tensor(self.coeffs, dtype=torch.float32, device=dev),
            "gains": torch.from_numpy(self._gains.copy()).to(dev),
        } | (self._agc_state() if self.with_agc else {})

    def _agc_state(self) -> State:
        dev = self.device
        S = self.n_streams
        agc = torch.zeros((3, S), dtype=torch.float32, device=dev)
        agc[2] = 1.0  # rows: rms_sum, peak, gain
        rdt = torch.bfloat16 if self._agc_ring == "bf16" else torch.float32
        ag = self._agc_group
        # a square per frame and lane, or a group sum per group and stream
        shape = (AGC_RING_FRAMES // ag, S) if ag else (AGC_RING_FRAMES, self._wide)
        return {
            "agc": agc,
            "ring": torch.zeros(shape, dtype=rdt, device=dev),
            "agc_par": torch.tensor(self._agc_params, dtype=torch.float32,
                                    device=dev),
        }

    def set_agc_params(self, state: State, *, attack=None, release=None,
                       target_level=None, absolute_max_gain=None) -> State:
        """Live AGC knobs (agc.rs set_attack_time / set_release_time
        semantics), applied from the next block: a state update, read back
        to the host once here (not in ``emit``)."""
        if not self.with_agc:
            raise ValueError("set_agc_params needs with_agc=True")
        att, rel, tgt, mg, fl, invw = state["agc_par"].tolist()
        rate = self.spec.sample_rate

        def coeff(seconds):
            nanos = min(duration_to_nanos(seconds), 10_000_000_000)
            return float(duration_to_coefficient(0, rate, nanos=nanos))

        if attack is not None:
            att = coeff(attack)
        if release is not None:
            rel = coeff(release)
            if rel != 0.0 and self._agc_plan != "serial":
                raise ValueError(
                    f"this pipeline was built with agc_plan="
                    f"{self._agc_plan!r} (a rel0 plan, release_time=0); a "
                    "live nonzero release needs the serial plan")
        if target_level is not None:
            tgt = float(np.float32(target_level))
        if absolute_max_gain is not None:
            mg = float(np.float32(absolute_max_gain))
        return {**state, "agc_par": torch.tensor(
            (att, rel, tgt, mg, fl, invw), dtype=torch.float32,
            device=self.device)}

    def retune(self, state: State, kind: Optional[str] = None,
               freq: Optional[float] = None, q: Optional[float] = None) -> State:
        """Live filter retune (src/source/blt.rs:68-91): new coefficients
        swapped into the state; the biquad carries persist."""
        kind = self._kind if kind is None else kind
        freq = self._freq if freq is None else float(freq)
        q = self._q if q is None else float(q)
        co = blt_coefficients(kind, self.spec.sample_rate, freq, q).as_tuple()
        return {**state, "coeffs": torch.tensor(co, dtype=torch.float32,
                                                device=self.device)}

    def emit(self, state: State, n: int):
        o0 = state["out_o"]
        left, wts = self._taps(o0, n)
        extra = {}
        if self.with_agc:
            # the blocked rel0 plans take blocks of whole m*to-frame steps
            # (the wrapper checks n against step_frames)
            ag, plan = self._agc_group, self._agc_plan
            mix, bq, agc, ring = fused_resample_biquad_agc_mix(
                state["pcm"], left, wts, gains=state["gains"],
                coeffs=state["coeffs"], bq=state["bq"], agc=state["agc"],
                agc_params=state["agc_par"], ring=state["ring"],
                ring_row=(o0 // ag) % (AGC_RING_FRAMES // ag) if ag
                else o0 % AGC_RING_FRAMES, agc_group=ag, agc_plan=plan,
                step_frames=self._mto)
            extra = {"agc": agc, "ring": ring}
        else:
            mix, bq = fused_resample_biquad_mix(
                state["pcm"], left, wts, gains=state["gains"],
                coeffs=state["coeffs"], bq=state["bq"],
                channels=self.spec.channels)
        # validity + drain bookkeeping (conversions/resample.py)
        _, in_end = self.input.access_window(state["in"])
        _, _, valid, drained = drain_bookkeeping(left, in_end, state["drained"], n)
        return ({**state, "out_o": o0 + n, "drained": drained, "bq": bq,
                 **extra}, mask_block(mix, valid), valid)


class ChunkRingFeed:
    """The farm's device-resident rolling ring (rodio_tpu/flagship.py:783-895):
    the live-feed counterpart of FusedWidePipeline's PCM, so the streaming
    farm's constant-memory path runs K1 (in ring mode) instead of the
    unfused chain.

    The JAX feed writes whole chunks of ``fr`` frames (each with its
    boundary row) into a ring of ``ring_chunks`` chunks, as bf16 pieces the
    MXU multiplies exactly, and keeps the last ``fr`` frames of a push
    (``carry``) outside it. This ring holds f32 frames time-major, ``[R,
    wide]``, as K1's PCM is, and every pushed frame f lands at row f mod R,
    the carry included; so R = (ring_chunks + 1) * fr rows keep the same
    chunks readable: chunks [w - ring_chunks, w) and the carry, after w
    chunks are complete. The first push (``prime=True``) carries (Kp + 1) *
    fr frames (chunks 0 .. Kp-1 and the carry), each later one Kp * fr.

    ``precision`` takes the JAX values ("int3", "int2") and refuses others;
    the ring is f32 either way, exact for any content. The per-lane gains
    live in the state (``"gain"``: shard-varying content rides the state),
    and K1 applies them after the lerp. The JAX feed folds them into the
    PCM at push unless ``gain_post``; the two orders differ by rounding.

    The state's ``w`` (chunks complete) is a host int the host already
    knows (every push adds Kp), ``overflow`` and ``ended`` device flags.
    :meth:`push` writes the ring in place: the returned state shares it.
    """

    #: live input: no seekable past
    LIVE = True

    def __init__(self, wide: int, in_rate: int, fr: int, Kp: int,
                 ring_chunks: int, precision: str, per_lane_gain,
                 gain_post: bool = False, *, device: DeviceLike = None):
        from .utils.device import resolve_device

        if ring_chunks % Kp:
            raise ValueError(f"ring_chunks {ring_chunks} must be a multiple of Kp {Kp}")
        if precision not in ("int3", "int2"):
            raise ValueError(f"precision must be 'int3' or 'int2', got {precision!r}")
        self.spec = StreamSpec(wide, in_rate)
        self.device = resolve_device(device)
        self.fr, self.Kp, self.ring_chunks = int(fr), int(Kp), int(ring_chunks)
        self.precision = precision
        self.npc = 3 if precision == "int3" else 2
        self.gain_post = bool(gain_post)
        self.rows = (self.ring_chunks + 1) * self.fr
        g = np.asarray(per_lane_gain, np.float32)
        if g.shape != (wide,):
            raise ValueError(f"per_lane_gain must be [{wide}]")
        self._gain = g

    def total_frames(self):
        return None

    def init_state(self) -> State:
        dev = self.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        return {
            "ring": torch.zeros((self.rows, self.spec.channels), dtype=torch.float32,
                                device=dev),
            "w": 0,  # chunks complete (absolute)
            "overflow": false, "ended": false.clone(),
            "gain": torch.from_numpy(self._gain.copy()).to(dev),
        }

    def frames_written(self, state: State) -> int:
        """Frames pushed so far: (w + 1) * fr after the first push."""
        return (state["w"] + 1) * self.fr if state["w"] else 0

    def push(self, state: State, block: torch.Tensor, *, prime: bool = False) -> State:
        """Append one push: ``block`` [wide, (Kp + 1) * fr] f32 on the first
        (``prime``) push, [wide, Kp * fr] on later ones. Reads nothing back."""
        fr, Kp, R = self.fr, self.Kp, self.rows
        T = (Kp + 1) * fr if prime else Kp * fr
        if tuple(block.shape) != (self.spec.channels, T):
            raise ValueError(f"push block {tuple(block.shape)}, expected "
                             f"[{self.spec.channels}, {T}]")
        if prime != (state["w"] == 0):
            raise ValueError("the first push, and only it, takes prime=True")
        ring = state["ring"]
        at = self.frames_written(state) % R
        head = min(T, R - at)
        span = block.T
        ring[at:at + head].copy_(span[:head])
        if head < T:
            ring[:T - head].copy_(span[head:])
        return {**state, "w": state["w"] + Kp}

    def end(self, state: State) -> State:
        return {**state, "ended": torch.ones((), dtype=torch.bool, device=self.device)}


class FusedFarmPipeline(Node):
    """K1 in ring mode over a :class:`ChunkRingFeed`: resample + biquad +
    per-lane gain + stream mix of the streaming farm's live feed
    (rodio_tpu/flagship.py:897-1034). Coefficients live in the state (a
    retune rebuilds nothing). Each block of ``n`` (a multiple of m*to)
    needs chunks [c0, c0 + n/to) resident, c0 = out_o / to: the feed's
    ``overflow`` turns on when one is not yet written (w < c0 + K) or
    already overwritten (c0 < w - ring_chunks), on the same schedule as
    the JAX package's. ``m``, ``lookahead`` and ``firfold`` are the JAX
    kernel's schedule knobs: ``m`` only sets the block multiple here."""

    def __init__(self, feed: ChunkRingFeed, to_rate: int, n_streams: int,
                 kind: Optional[str] = "low_pass", freq: float = 2000.0,
                 q: float = 0.5, *, m: int = 2):
        self.input = feed
        self.device = feed.device
        wide = feed.spec.channels
        if wide % n_streams:
            raise ValueError("channel count not divisible by stream count")
        self.n_streams = n_streams
        C = wide // n_streams
        self.spec = StreamSpec(C, to_rate)
        g = math.gcd(feed.spec.sample_rate, to_rate)
        self.from_ = feed.spec.sample_rate // g
        self.to = to_rate // g
        if self.from_ != feed.fr:
            raise ValueError(f"the feed's chunks hold {feed.fr} frames, the ratio {self.from_}")
        if self.from_ == self.to or self.to < 2:
            # ROADMAP F3: the JAX package refuses the identity ratio
            raise ValueError("fused farm needs a non-identity rational rate ratio")
        self.m = int(m)
        self.precision = feed.precision
        self._kind, self._freq, self._q = kind, float(freq), float(q)
        # no filter stage requested: the identity biquad (b0 = 1)
        self.coeffs = ((1.0, 0.0, 0.0, 0.0, 0.0) if kind is None else
                       blt_coefficients(kind, to_rate, freq, q).as_tuple())
        self._taps = _LerpTaps(self.from_, self.to, self.device)

    def total_frames(self) -> Optional[int]:
        return None

    def init_state(self) -> State:
        dev = self.device
        return {
            "in": self.input.init_state(),
            "out_o": 0,  # host int: advances by n per emit
            "bq": torch.zeros((4, self.input.spec.channels), dtype=torch.float32,
                              device=dev),
            "coeffs": torch.tensor(self.coeffs, dtype=torch.float32, device=dev),
        }

    def retune(self, state: State, kind: Optional[str] = None,
               freq: Optional[float] = None, q: Optional[float] = None) -> State:
        """Live retune (src/source/blt.rs:68-91): new coefficients into the
        state; the carries persist."""
        kind = self._kind if kind is None else kind
        freq = self._freq if freq is None else float(freq)
        q = self._q if q is None else float(q)
        co = blt_coefficients(kind, self.spec.sample_rate, freq, q).as_tuple()
        return {**state, "coeffs": torch.tensor(co, dtype=torch.float32,
                                                device=self.device)}

    def emit(self, state: State, n: int):
        to = self.to
        if n % (self.m * to):
            raise ValueError(f"a fused farm block must be a multiple of {self.m * to}")
        K = n // to
        ins = state["in"]
        o0 = state["out_o"]
        c0 = o0 // to  # absolute chunk index
        w, Nc = ins["w"], self.input.ring_chunks
        if w < c0 + K or c0 < w - Nc:  # host ints: no read-back
            ins = {**ins, "overflow": torch.ones_like(ins["overflow"])}
        left, wts = self._taps(o0, n)
        mix, bq = fused_resample_biquad_mix(
            ins["ring"], left, wts, gains=ins["gain"], coeffs=state["coeffs"],
            bq=state["bq"], channels=self.spec.channels, ring=True)
        return ({**state, "in": ins, "out_o": o0 + n, "bq": bq}, mix,
                full_valid(n, self.device))


def make_flagship(n_streams: int = 512, *, seconds: float = 4.0,
                  in_rate: int = 44100, out_rate: int = 48000,
                  channels: int = 2, seed: int = 0, scan_mode: str = "exact",
                  with_agc: bool = False,
                  source_pcm: Optional[np.ndarray] = None,
                  max_block: int = 8192, precision: str = "auto",
                  agc_ring: str = "bf16", agc_group: int = 0,
                  agc_plan: str = "auto", block_bf16: bool = False,
                  device: DeviceLike = None):
    """Build (master_node, state) for the flagship pipeline.

    The PCM and gains come from numpy with ``seed``, exactly as the JAX
    package makes them, so both packages see identical input. ``scan_mode``
    "fused" builds FusedWidePipeline -> Limit (K1, or K2 with the AGC, then
    K3); "exact", "auto" and "pallas" build the unfused chain (on a CUDA
    device "auto" and "pallas" run K4 and K3, and with the AGC "pallas"
    runs K6; the AGC's "auto" mode is not ported and raises). ``agc_ring``,
    ``agc_group`` and ``agc_plan`` are the fused AGC's knobs. ``block_bf16``
    inserts a ``Bf16Boundary`` after the resampler, so K4 reads and writes
    bf16 blocks (``conversions/blockdtype.py``); as in the JAX package it
    runs only with ``scan_mode="pallas"`` and no AGC, and raises
    ``NotImplementedError`` otherwise (ROADMAP F7).
    """
    rng = np.random.default_rng(seed)
    frames = int(seconds * in_rate)
    if source_pcm is None:
        base = rng.standard_normal((channels, frames)).astype(np.float32) * 0.1
    else:
        base = np.asarray(source_pcm, dtype=np.float32)
        if base.shape[1] < frames:
            reps = -(-frames // base.shape[1])
            base = np.tile(base, (1, reps))
        base = base[:channels, :frames]

    # wide-channel data: [S*C, frames], each stream a rotated copy
    shifts = rng.integers(0, frames, size=n_streams)
    wide = np.empty((n_streams * channels, frames), dtype=np.float32)
    for s in range(n_streams):
        wide[s * channels : (s + 1) * channels] = np.roll(
            base, int(shifts[s]), axis=1
        )
    gains = (
        rng.uniform(0.5, 1.5, size=n_streams).astype(np.float32) / n_streams
    )

    # pad the buffer for the largest window a block of max_block needs
    g = np.gcd(in_rate, out_rate)
    fr_, to_ = in_rate // g, out_rate // g
    pad_needed = (max_block // to_ + 2) * fr_
    chain = SamplesBuffer(
        n_streams * channels, in_rate, wide,
        pad_frames=max(8192, -(-pad_needed // 256) * 256), device=device,
    )
    if scan_mode == "fused":
        fused = FusedWidePipeline(chain, out_rate, gains, n_streams,
                                  "low_pass", 2000.0, 0.5, precision=precision,
                                  with_agc=with_agc, agc_ring=agc_ring,
                                  agc_group=agc_group, agc_plan=agc_plan)
        master = Limit(fused, LimitSettings(), mode="auto")
        return master, master.init_state()
    if scan_mode not in ("exact", "auto", "pallas"):
        raise NotImplementedError(f"scan_mode {scan_mode!r} is not ported")
    if block_bf16 and (with_agc or scan_mode != "pallas"):
        # the JAX package runs bf16 blocks only on the Pallas biquad without
        # the AGC: its exact scan keeps an f32 carry against a bf16 block,
        # and its AGC kernels have no bf16 instance (ROADMAP F7)
        raise NotImplementedError(
            "block_bf16 runs only with scan_mode='pallas' and no AGC: the JAX "
            f"package cannot run scan_mode={scan_mode!r}, with_agc={with_agc} "
            "(ROADMAP F7)")
    chain = Resample(chain, out_rate, max_block=max_block)
    if block_bf16:
        chain = Bf16Boundary(chain)
    chain = BltFilter(chain, "low_pass", 2000.0, 0.5, mode=scan_mode)
    if with_agc:
        chain = AutomaticGainControl(chain, AgcSettings(), mode=scan_mode,
                                     streams=n_streams)
    chain = Amplify(chain, np.repeat(gains, channels))
    chain = WideMixer(chain, n_streams)
    master = Limit(chain, LimitSettings(), mode=scan_mode)
    return master, master.init_state()


def make_per_stream_chain(n_streams: int = 512, *, seconds: float = 4.0,
                          seed: int = 0, mode: str = "pallas",
                          device: DeviceLike = None):
    """Build (master_node, state) for the per-stream chain: every stream of
    BASELINE config 5 (44.1 -> 48 kHz) through its own stateful effects, as the JAX
    package's sharded pipeline builds them (tests/test_parallel.py:106-117,
    ``__graft_entry__.py``), then the mix and the master limiter:

      SamplesBuffer -> Resample -> BltFilter (low-pass 2 kHz, Q 0.5)
        -> AutomaticGainControl(streams=S) -> Amplify(per-stream gain)
        -> Limit(streams=S) -> WideMixer -> Limit (the master bus)

    ``mode`` goes to every node: "pallas" runs K4, K6, K5 and K3 on the
    card (the JAX package's TPU dispatch), "exact" the sequential scans
    (K4 and K5 on the card, which run the same recurrences). The PCM and
    gains come from numpy with ``seed``."""
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((n_streams * 2, int(seconds * 44100)))
           * 0.1).astype(np.float32)
    gains = np.repeat(rng.uniform(0.5, 1.5, n_streams).astype(np.float32)
                      / n_streams, 2)
    node = Resample(SamplesBuffer(n_streams * 2, 44100, pcm, device=device),
                    48000)
    node = BltFilter(node, "low_pass", 2000.0, 0.5, mode=mode)
    node = AutomaticGainControl(node, AgcSettings(), mode=mode, streams=n_streams)
    node = Limit(Amplify(node, gains), LimitSettings(), mode=mode,
                 streams=n_streams)
    master = Limit(WideMixer(node, n_streams), LimitSettings(), mode=mode)
    return master, master.init_state()
