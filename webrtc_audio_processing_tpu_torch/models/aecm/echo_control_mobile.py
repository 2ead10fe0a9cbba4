"""AECM frame wrapper: 10 ms frames -> 64-sample core blocks, on N rows.

Port of ``webrtc_audio_processing_tpu/models/aecm/echo_control_mobile.py``
(reference: aecm/echo_control_mobile.{h,cc} and aecm_core.cc
WebRtcAecm_ProcessFrame: the frame rebuffering, the far frame fetched by
the known delay, the output stuffing; BufferFarFrame / FetchFarFrame).

As in the JAX package:
- the reference's ECstartup / checkBuffSize / EstBufDelay machinery
  (echo_control_mobile.cc:289-363, 538-576) is a per-canceller scalar
  state machine; the far-end FIFO (WebRtc ring_buffer) is an
  absolute-sample ring with read and write counters, MoveReadPtr a
  clamped counter jump;
- the 80-sample sub-frames are rebuffered into 64-sample blocks from the
  first enabled frame on; the startup exit frame depends on the data, so
  the leftover length is state (``rebuf_fill``, cycling through 0, 16,
  32, 48), not a static phase. Both blocks a sub-frame can yield are
  computed every sub-frame and the second is committed by a select;
- the output's short-fall stuffing (aecm_core.cc:1380-1386) reads an
  output ring whose read pointer can move back into zero-initialized
  space on the first frames;
- every per-canceller branch is a ``torch.where``: no step reads a value
  on the host, so a CUDA graph can capture it.

The JAX package builds the leftover-and-new assembly as a 4-way one-hot
select; here it is one gather with a per-row index.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aecm import core as aecm_core
from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops

I32 = torch.int32
I64 = torch.int64

FAR_RING = 8192  # > FIFO_CAP + the most in flight; a power of two
OUT_RING = 512
SUB = 80  # FRAME_LEN: the reference rebuffers in 80-sample frames
FIFO_CAP = 50 * SUB  # kBufSizeSamp (echo_control_mobile.cc:32-39)
CORE_FAR_LEN = 256  # FAR_BUF_LEN = PART_LEN4 (aecm_defines.h:19-25)
LEFTOVER = 48


def _block_schedule(frame_len: int):
    """The leftover and block counts of frame_len -> 64-sample blocks over
    their cycle."""
    period = 64 // math.gcd(frame_len, 64)
    leftovers, blocks = [], []
    l = 0
    for _ in range(period):
        leftovers.append(l)
        blocks.append((l + frame_len) // aecm_core.PART_LEN)
        l = (l + frame_len) % aecm_core.PART_LEN
    return tuple(leftovers), tuple(blocks)


@dataclass(frozen=True)
class AecmGeometry:
    """Static AECM configuration (echo_control_mobile.cc AecmConfig)."""

    sample_rate_hz: int = 16000  # the band-0 rate: 8000 or 16000
    echo_mode: int = 3  # routing mode 0-4 (default Speakerphone)
    cng: bool = True
    nlp: bool = True

    @property
    def frame_len(self) -> int:
        return self.sample_rate_hz // 100

    @property
    def mult(self) -> int:
        return self.sample_rate_hz // 8000

    @property
    def period(self) -> int:
        # The 80 -> 64 rebuffer phase is state (rebuf_fill), not a static
        # schedule: one step covers every frame, as in the JAX package.
        return 1

    @property
    def schedule(self):
        return _block_schedule(self.frame_len)


@dataclass
class AecmState:
    """One canceller per row; leaves (N, ...) int32 unless noted."""

    core: aecm_core.AecmCoreState
    far_ring: torch.Tensor  # (N, FAR_RING) raw render history
    far_written: torch.Tensor  # (N,) absolute samples written (FIFO wr)
    far_leftover: torch.Tensor  # (N, 48) synced far tail (valid: rebuf_fill)
    near_leftover: torch.Tensor  # (N, 48)
    rebuf_fill: torch.Tensor  # (N,) leftover length in {0, 16, 32, 48}
    near_abs: torch.Tensor  # (N,) absolute near samples consumed
    out_ring: torch.Tensor  # (N, OUT_RING)
    out_written: torch.Tensor  # (N,)
    out_read: torch.Tensor  # (N,)
    # The AecMobile FIFO, startup and buffer-delay machinery
    # (echo_control_mobile.h:40-70), per-canceller scalars.
    fifo_read: torch.Tensor  # (N,) farendBuf read position (abs samples)
    ec_startup: torch.Tensor  # (N,) bool
    check_buff_size: torch.Tensor  # (N,) bool
    check_buf_size_ctr: torch.Tensor  # (N,)
    stable_counter: torch.Tensor  # (N,) (aecm->counter)
    first_val: torch.Tensor  # (N,) ms
    ms_sum: torch.Tensor  # (N,) (aecm->sum)
    buf_size_start: torch.Tensor  # (N,) frames
    ms_in_sndcard: torch.Tensor  # (N,) last clamped delay report + 10
    filt_delay: torch.Tensor  # (N,)
    known_delay: torch.Tensor  # (N,)
    last_known_delay: torch.Tensor  # (N,) (core lastKnownDelay)
    last_delay_diff: torch.Tensor  # (N,)
    time_for_delay_change: torch.Tensor  # (N,)
    farend_old: torch.Tensor  # (N, 2, SUB) the last FIFO frames
    # The core's far buffer (aecm_core farBuf): the stream after the FIFO.
    fetched_ring: torch.Tensor  # (N, CORE_FAR_LEN)
    fetched_written: torch.Tensor  # (N,) abs (farBufWritePos mod 512)
    fetch_read: torch.Tensor  # (N,) abs (farBufReadPos mod 512)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(geo: AecmGeometry, n: int, device) -> AecmState:
    def zeros(*shape, dtype=I32):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)

    def flag(value):
        return torch.full((n,), value, dtype=torch.bool, device=device)

    return AecmState(
        core=aecm_core.init_core(geo.sample_rate_hz, geo.echo_mode, n,
                                 device),
        far_ring=zeros(FAR_RING), far_written=zeros(),
        far_leftover=zeros(LEFTOVER), near_leftover=zeros(LEFTOVER),
        rebuf_fill=zeros(), near_abs=zeros(),
        out_ring=zeros(OUT_RING), out_written=zeros(), out_read=zeros(),
        fifo_read=zeros(), ec_startup=flag(True), check_buff_size=flag(True),
        check_buf_size_ctr=zeros(), stable_counter=zeros(),
        first_val=zeros(), ms_sum=zeros(), buf_size_start=zeros(),
        ms_in_sndcard=zeros(), filt_delay=zeros(), known_delay=zeros(),
        last_known_delay=zeros(), last_delay_diff=zeros(),
        time_for_delay_change=zeros(), farend_old=zeros(2, SUB),
        fetched_ring=zeros(CORE_FAR_LEN), fetched_written=zeros(),
        fetch_read=zeros(),
    )


def _positions(start: torch.Tensor, n: int, ring: int) -> torch.Tensor:
    """(N, n) int64 ring positions of ``n`` samples from ``start`` (N,)."""
    steps = batch_ops.const(tuple(range(n)), I64, start.device)
    return torch.remainder(start.to(I64)[:, None] + steps, ring)


def _lanes(n: int, device) -> torch.Tensor:
    return batch_ops.const(tuple(range(n)), I32, device)


def buffer_farend(state: AecmState, far_frame: torch.Tensor) -> AecmState:
    """WebRtcAecm_BufferFarend (echo_control_mobile.cc:210-239): DelayComp
    when enabled, then WriteBuffer (the tail dropped when the FIFO is
    full). far_frame: (N, n) int16-valued."""
    n = far_frame.shape[1]
    mult = n // SUB  # nrOfSamples is one 10 ms frame: 80 * mult

    # WebRtcAecm_DelayComp (echo_control_mobile.cc:579-600), enabled only.
    avail = state.far_written - state.fifo_read
    n_snd = state.ms_in_sndcard * 8 * mult
    comp = (~state.ec_startup) & (n_snd - avail > CORE_FAR_LEN - SUB * mult)
    n_add = torch.clamp((n_snd >> 1) - avail, min=SUB, max=10 * SUB)
    # MoveReadPtr(-n_add): a backward move clamped by the free space
    # (ring_buffer.c:172-199).
    move_back = torch.where(comp, torch.minimum(n_add, FIFO_CAP - avail), 0)
    fifo_read = state.fifo_read - move_back

    # WriteBuffer: min(free, n) samples, the rest dropped.
    n_write = torch.clamp(FIFO_CAP - (state.far_written - fifo_read),
                          max=n)
    idx = _positions(state.far_written, n, FAR_RING)
    keep = _lanes(n, far_frame.device) < n_write[:, None]
    new = torch.where(keep, far_frame.to(I32),
                      torch.gather(state.far_ring, 1, idx))
    return state.replace(far_ring=state.far_ring.scatter(1, idx, new),
                         far_written=state.far_written + n_write,
                         fifo_read=fifo_read)


def trunc_div(a: torch.Tensor, b) -> torch.Tensor:
    """C integer division (toward zero) for a possibly negative ``a``."""
    q = torch.abs(a) // b
    return torch.where(a < 0, -q, q)


def _startup_step(geo: AecmGeometry, state: AecmState, ms):
    """The ECstartup branch of WebRtcAecm_Process
    (echo_control_mobile.cc:289-362): checkBuffSize's stabilization and the
    startup exit with the FIFO trimmed to bufSizeStart frames. Returns the
    state, its core untouched; the output is the near end itself."""
    mult = geo.mult
    avail0 = state.far_written - state.fifo_read
    filled = avail0 // SUB

    ctr = state.check_buf_size_ctr + 1
    fresh = state.stable_counter == 0
    first_val = torch.where(fresh, ms, state.first_val)
    ms_sum0 = torch.where(fresh, 0, state.ms_sum)
    # |firstVal - ms| < max(0.2 * ms, 8) in C double
    # (echo_control_mobile.cc:316-318): for integers exactly 5|d| < ms;
    # kSampMsNb = 8.
    delta = torch.abs(first_val - ms)
    stable = (5 * delta < ms) | (delta < 8)
    ms_sum = torch.where(stable, ms_sum0 + ms, ms_sum0)
    counter = torch.where(stable, state.stable_counter + 1, 0)

    done1 = state.check_buff_size & (counter >= 6)
    bss1 = torch.clamp(trunc_div(3 * ms_sum * mult,
                                 torch.clamp(counter, min=1) * 40), max=50)
    done2 = state.check_buff_size & (ctr > 50)
    bss2 = torch.clamp((3 * ms * mult) // 40, max=50)
    buf_size_start = torch.where(done1, bss1, state.buf_size_start)
    buf_size_start = torch.where(done2, bss2, buf_size_start)
    check_buff = state.check_buff_size & ~(done1 | done2)

    # The startup exit (echo_control_mobile.cc:345-361); `filled` is taken
    # before the checkBuffSize update, as in the reference.
    exit_gt = filled > buf_size_start
    ends = (~check_buff) & ((filled == buf_size_start) | exit_gt)
    fifo_read = state.fifo_read + torch.where(
        exit_gt & ~check_buff, avail0 - buf_size_start * SUB, 0)
    return state.replace(
        fifo_read=fifo_read, ec_startup=~ends, check_buff_size=check_buff,
        check_buf_size_ctr=ctr, stable_counter=counter, first_val=first_val,
        ms_sum=ms_sum, buf_size_start=buf_size_start)


def _assemble(leftover: torch.Tensor, new80: torch.Tensor,
              fill: torch.Tensor) -> torch.Tensor:
    """(N, 128): leftover[:fill] then new80, zero-padded, per row."""
    dev = new80.device
    k = _lanes(2 * aecm_core.PART_LEN, dev)[None]
    f = fill[:, None]
    src = torch.where(k < f, k, torch.where(k < f + SUB, LEFTOVER + k - f,
                                            LEFTOVER + SUB))
    pool = torch.cat([leftover, new80, torch.zeros_like(new80[:, :1])], 1)
    return torch.gather(pool, 1, src.to(I64))


def _est_buf_delay(state_fields: dict, far_written, fifo_read, ms, mult):
    """EstBufDelay once all the frame's data is read
    (echo_control_mobile.cc:387-391, body :530-577). Returns the new
    fifo_read and updates the delay fields in ``state_fields``."""
    filt_delay = state_fields["filt_delay"]
    known_delay = state_fields["known_delay"]
    last_delay_diff = state_fields["last_delay_diff"]
    tfc = state_fields["time_for_delay_change"]
    n_samp_far = far_written - fifo_read
    delay_new = ms * 8 * mult - n_samp_far  # kSampMsNb * mult
    stuff = delay_new < SUB
    # MoveReadPtr(FRAME_LEN) clamps the forward motion to what is readable.
    fifo_read = fifo_read + torch.where(
        stuff, torch.clamp(n_samp_far, min=0, max=SUB), 0)
    delay_new = delay_new + stuff.to(I32) * SUB
    filt_delay = torch.clamp(trunc_div(8 * filt_delay + 2 * delay_new, 10),
                             min=0)
    diff = filt_delay - known_delay
    tfc = torch.where(
        diff > 224, torch.where(last_delay_diff < 96, 0, tfc + 1),
        torch.where((diff < 96) & (known_delay > 0),
                    torch.where(last_delay_diff > 224, 0, tfc + 1), 0))
    state_fields.update(
        filt_delay=filt_delay, last_delay_diff=diff,
        time_for_delay_change=tfc,
        known_delay=torch.where(tfc > 25, torch.clamp(filt_delay - 160,
                                                      min=0), known_delay))
    return fifo_read


def _enabled_step(geo: AecmGeometry, state: AecmState,
                  near_frame: torch.Tensor, ms):
    """The enabled branch (echo_control_mobile.cc:364-403), per 80-sample
    sub-frame: the FIFO read (or farendOld reused), EstBufDelay once per
    10 ms, the core's far buffering and fetch, the 64-sample blocks after
    the leftover, the output's short-fall stuffing. Returns (state,
    out_frame (N, frame_len))."""
    mult = geo.mult
    est_idx = 0 if geo.sample_rate_hz == 8000 else 1
    dev = near_frame.device
    lanes = _lanes(SUB, dev)

    core = state.core
    out_ring, out_written = state.out_ring, state.out_written
    out_read = state.out_read
    near_l, far_l, fill = state.near_leftover, state.far_leftover, \
        state.rebuf_fill
    fifo_read = state.fifo_read
    farend_old = list(state.farend_old.unbind(1))
    delay_fields = dict(filt_delay=state.filt_delay,
                        known_delay=state.known_delay,
                        last_delay_diff=state.last_delay_diff,
                        time_for_delay_change=state.time_for_delay_change)
    fetched_ring = state.fetched_ring
    fetched_written, fetch_read = state.fetched_written, state.fetch_read

    outs = []
    for s in range(mult):
        # The FIFO read of one 80-sample frame, or the last frame reused
        # (echo_control_mobile.cc:369-386 farendOld).
        have = state.far_written - fifo_read >= SUB
        far_fifo = torch.where(
            have[:, None],
            torch.gather(state.far_ring, 1,
                         _positions(fifo_read, SUB, FAR_RING)),
            farend_old[s])
        farend_old[s] = far_fifo
        fifo_read = fifo_read + have.to(I32) * SUB
        if s == est_idx:
            fifo_read = _est_buf_delay(delay_fields, state.far_written,
                                       fifo_read, ms, mult)

        # The core's BufferFarFrame + FetchFarFrame (aecm_core.cc:514-529,
        # 1072-1127). The core's knownDelay is 0 in M145 and never written
        # again (aecm_core.cc:385), so the core's far path is a plain FIFO
        # whose read chases its write 80 samples a sub-frame from 0 each:
        # the fetched frame is the one just buffered.
        fetched_ring = fetched_ring.scatter(
            1, _positions(fetched_written, SUB, CORE_FAR_LEN), far_fifo)
        fetched_written = fetched_written + SUB
        far_core = far_fifo
        fetch_read = fetch_read + SUB

        # 80 new samples behind the leftover: fill + 80 yields one block,
        # two at fill == 48 (the reference's while-available >= 64 loop,
        # aecm_core.cc:541-561). Both are computed; the second is
        # committed only where it exists.
        near_cat = _assemble(near_l, near_frame[:, s * SUB:(s + 1) * SUB],
                             fill)
        far_cat = _assemble(far_l, far_core, fill)
        two = fill == LEFTOVER
        core1, out_b0 = aecm_core.process_block(
            core, far_cat[:, :64], near_cat[:, :64], mult,
            echo_mode=geo.echo_mode, nlp=geo.nlp, cng=geo.cng)
        core2, out_b1 = aecm_core.process_block(
            core1, far_cat[:, 64:], near_cat[:, 64:], mult,
            echo_mode=geo.echo_mode, nlp=geo.nlp, cng=geo.cng)
        core = batch_ops.tree_where(two, core2, core1)
        out_ring = out_ring.scatter(
            1, _positions(out_written, 64, OUT_RING), out_b0)
        out_written = out_written + 64
        oidx = _positions(out_written, 64, OUT_RING)
        out_ring = out_ring.scatter(1, oidx, torch.where(
            two[:, None], out_b1, torch.gather(out_ring, 1, oidx)))
        out_written = out_written + two.to(I32) * 64

        # The new leftover: the tail past the blocks used, at most 48
        # samples after one block, none after two.
        near_l = torch.where(two[:, None], 0, near_cat[:, 64:112])
        far_l = torch.where(two[:, None], 0, far_cat[:, 64:112])
        fill = torch.where(two, 0, fill + 16)

        # Output stuffing per sub-frame (aecm_core.cc:1345-1351): on a
        # short-fall the read pointer moves back over the ring's history.
        out_read = torch.where(out_written - out_read < SUB,
                               out_written - SUB, out_read)
        got = torch.gather(out_ring, 1, _positions(out_read, SUB, OUT_RING))
        outs.append(torch.where(out_read[:, None] + lanes >= 0, got, 0))
        out_read = out_read + SUB

    return state.replace(
        core=core, near_leftover=near_l, far_leftover=far_l,
        rebuf_fill=fill, out_ring=out_ring, out_written=out_written,
        out_read=out_read, fifo_read=fifo_read,
        farend_old=torch.stack(farend_old, 1), fetched_ring=fetched_ring,
        fetched_written=fetched_written, fetch_read=fetch_read,
        **delay_fields,
    ), torch.cat(outs, 1)


def process_frame(geo: AecmGeometry, state: AecmState,
                  near_frame: torch.Tensor, stream_delay_ms):
    """One 10 ms capture frame: WebRtcAecm_Process
    (echo_control_mobile.cc:240-403).

    near_frame: (N, frame_len) int16-valued; stream_delay_ms: the reported
    delay, an int or (N,) int32 (set_stream_delay_ms). Returns (state,
    out_frame (N, frame_len) int32).

    Both the startup and the enabled branch run every frame; a select on
    ``ec_startup`` keeps one per canceller. The reference processes
    ``mult`` 80-sample sub-frames a 10 ms frame at either rate, each with
    its own 64-sample rebuffering and 80-sample output read, and so does
    this, so the output is sample-aligned with the reference's."""
    near_frame = near_frame.to(I32)
    n = near_frame.shape[0]
    delay = stream_delay_ms
    if not torch.is_tensor(delay):
        delay = torch.full((n,), int(delay), dtype=I32,
                           device=near_frame.device)
    # msInSndCardBuf clamped, + 10 (echo_control_mobile.cc:270-285).
    ms = torch.clamp(delay.to(I32), 0, 500) + 10
    base = state.replace(ms_in_sndcard=ms,
                         near_abs=state.near_abs + geo.frame_len)
    st_startup = _startup_step(geo, base, ms)
    st_enabled, out_enabled = _enabled_step(geo, base, near_frame, ms)
    startup = state.ec_startup
    new_state = batch_ops.tree_where(startup, st_startup, st_enabled)
    return new_state, torch.where(startup[:, None], near_frame, out_enabled)


def get_echo_likelihood(state: AecmState) -> torch.Tensor:
    """A rough echo-activity proxy from the suppression gain, (N,)."""
    g = state.core.sup_gain.to(torch.float32) / float(
        aecm_core.SUPGAIN_DEFAULT)
    return 1.0 - torch.clamp(g, 0.0, 1.0)
