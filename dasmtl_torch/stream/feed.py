"""Live ingestion: per-fiber ring buffers and chunk sources.

A copy of ``dasmtl/stream/feed.py`` (:39-377): :class:`FiberFeed`,
:class:`PlantedEvent`, :data:`EVENT_AMPLITUDE`, :class:`SyntheticSource`,
:class:`FileTailSource`, :class:`SocketSource` and
:func:`source_from_spec`.  It holds no device code: the same numpy and
stdlib as the JAX package's module, so a fiber fed to either package gives
the same samples.

:class:`FiberFeed` is the host ring of the most recent ``ring_samples``
samples, addressed by *absolute* sample index, so a windower that falls
behind sees an overrun instead of reading overwritten data.  The sources
share one protocol: ``channels``, ``poll(max_samples) -> (channels, k) |
None``, ``close()`` and ``resume_from(offset)``.
"""

from __future__ import annotations

import dataclasses
import socket as socketlib
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np


class FiberFeed:
    """Append-only ring buffer over one fiber's ``(channels, time)`` samples.

    ``total`` is the absolute stream position (samples ever appended);
    the ring retains ``[oldest, total)``.  ``view`` raises on any read
    outside that range — falling behind the ring is an *overrun* the
    caller must handle explicitly (:class:`~dasmtl_torch.stream.windower.
    LiveWindower` skips forward and counts the loss), never a silent
    wrap-around read.

    ``append`` also timestamps arrivals so the sample->event latency
    histogram can anchor on when a window's data actually landed:
    ``arrival_time(i)`` returns the clock reading of the append that
    first made sample ``i`` available.
    """

    def __init__(self, channels: int, ring_samples: int,
                 dtype=np.float32):
        if channels < 1 or ring_samples < 1:
            raise ValueError(f"channels {channels} and ring_samples "
                             f"{ring_samples} must be >= 1")
        self.channels = int(channels)
        self.ring_samples = int(ring_samples)
        self._buf = np.zeros((self.channels, self.ring_samples), dtype)
        self.total = 0
        # First index ever appendable: 0, or the resume_from offset —
        # samples below it were never appended here and must not read
        # as zeros just because the ring slots exist.
        self._floor = 0
        # (total_after_append, clock_reading) pairs, oldest first; pruned
        # to entries still covering retained samples.
        self._arrivals: deque = deque()

    @property
    def floor(self) -> int:
        """First absolute sample index this ring ever covered: 0, or
        the last ``resume_from`` offset."""
        return self._floor

    @property
    def oldest(self) -> int:
        """First absolute sample index still retained."""
        return max(self._floor, self.total - self.ring_samples)

    def append(self, chunk: np.ndarray, now: float = 0.0) -> int:
        """Append ``(channels, n_new)`` samples; returns ``n_new``.  A
        chunk wider than the ring keeps only its newest tail (the older
        part is already unreadable by definition)."""
        chunk = np.asarray(chunk)
        if chunk.ndim != 2 or chunk.shape[0] != self.channels:
            raise ValueError(f"chunk shape {chunk.shape} != "
                             f"({self.channels}, n_new)")
        n = chunk.shape[1]
        if n == 0:
            return 0
        if n >= self.ring_samples:
            # Oversized chunk: only its newest ring-width tail is ever
            # readable; write it at the slots its absolute indices map to.
            chunk = chunk[:, n - self.ring_samples:]
            pos = (self.total + n - self.ring_samples) % self.ring_samples
        else:
            pos = self.total % self.ring_samples
        end = pos + chunk.shape[1]
        if end <= self.ring_samples:
            self._buf[:, pos:end] = chunk
        else:
            first = self.ring_samples - pos
            self._buf[:, pos:] = chunk[:, :first]
            self._buf[:, :end - self.ring_samples] = chunk[:, first:]
        self.total += n
        self._arrivals.append((self.total, now))
        while (len(self._arrivals) > 1
               and self._arrivals[1][0] <= self.oldest):
            self._arrivals.popleft()
        return n

    def view(self, t0: int, n: int) -> np.ndarray:
        """Copy of absolute samples ``[t0, t0 + n)`` as ``(channels, n)``."""
        if t0 < self.oldest:
            raise IndexError(f"samples from {t0} overwritten — ring "
                             f"retains [{self.oldest}, {self.total})")
        if t0 + n > self.total:
            raise IndexError(f"samples to {t0 + n} not yet appended "
                             f"(total {self.total})")
        pos = t0 % self.ring_samples
        end = pos + n
        if end <= self.ring_samples:
            return self._buf[:, pos:end].copy()
        return np.concatenate(
            [self._buf[:, pos:], self._buf[:, :end - self.ring_samples]],
            axis=1)

    def arrival_time(self, sample: int) -> float:
        """Clock reading of the append that first covered ``sample``
        (0.0 if unknown — e.g. already pruned)."""
        for covered, now in self._arrivals:
            if covered > sample:
                return now
        return self._arrivals[-1][1] if self._arrivals else 0.0

    def resume_from(self, offset: int) -> None:
        """Reposition an (empty or restarted) ring at absolute sample
        ``offset``: the ring forgets everything it held and the next
        ``append`` lands at ``offset`` — the receiving half of the
        fleet's migration/failover handshake, so a fiber resumed on a
        new worker keeps the SAME absolute sample addressing its track
        records and resume offsets are stated in."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"resume offset {offset} must be >= 0")
        self._buf[:] = 0
        self.total = offset
        self._floor = offset
        self._arrivals.clear()


# -- chunk sources -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlantedEvent:
    """Ground truth for one synthetic event: ``onset``/``duration`` in
    samples, ``event`` type (0 striking / 1 excavating), and the center
    channel of its 8-channel span on the fiber."""

    onset: int
    duration: int
    event: int
    center_channel: int


#: Signal amplitudes per event type, chosen so per-channel-group RMS over
#: a full window separates cleanly: background noise (std 1.0) -> RMS ~1;
#: striking (A=8) -> RMS ~5.7; excavating (A=16) -> RMS ~11.4.  The soak
#: oracle detector thresholds at 2.5 and 8.0 (dasmtl_torch/stream/selftest.py).
EVENT_AMPLITUDE = (8.0, 16.0)

#: Channels an event's signal rides on (group-aligned spans keep the
#: oracle's 16-group RMS argmax crisp).
EVENT_SPAN_CHANNELS = 8


class SyntheticSource:
    """Deterministic synthetic fiber: unit-variance Gaussian background
    plus planted sinusoid events, generated chunk-by-chunk so an
    unbounded stream never materializes.  ``nan_samples`` poisons single
    samples (channel ``nan_channel``) to exercise the serve tier's
    SAN202 per-window rejection downstream."""

    def __init__(self, channels: int, *, seed: int = 0,
                 events: Sequence[PlantedEvent] = (),
                 nan_samples: Sequence[int] = (),
                 nan_channel: Optional[int] = None):
        self.channels = int(channels)
        self.events = tuple(events)
        self.nan_samples = frozenset(int(s) for s in nan_samples)
        self.nan_channel = (self.channels // 2 if nan_channel is None
                            else int(nan_channel))
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._pos = 0

    def poll(self, max_samples: int) -> Optional[np.ndarray]:
        n = int(max_samples)
        if n <= 0:
            return None
        p0 = self._pos
        out = self._rng.standard_normal((self.channels, n)
                                        ).astype(np.float32)
        t = np.arange(p0, p0 + n, dtype=np.float64)
        for ev in self.events:
            lo = max(p0, ev.onset)
            hi = min(p0 + n, ev.onset + ev.duration)
            if lo >= hi:
                continue
            c0 = max(0, min(self.channels - EVENT_SPAN_CHANNELS,
                            ev.center_channel - EVENT_SPAN_CHANNELS // 2))
            amp = EVENT_AMPLITUDE[ev.event]
            wave = amp * np.sin(
                2.0 * np.pi * 0.05 * t[lo - p0:hi - p0]).astype(np.float32)
            out[c0:c0 + EVENT_SPAN_CHANNELS, lo - p0:hi - p0] += wave
        for s in self.nan_samples:
            if p0 <= s < p0 + n:
                out[self.nan_channel, s - p0] = np.nan
        self._pos += n
        return out

    def resume_from(self, offset: int) -> None:
        """Reposition the generator at absolute sample ``offset``.  The
        planted events replay EXACTLY (they are deterministic functions
        of absolute sample index); the Gaussian background re-draws
        from a ``(seed, offset)``-keyed stream — statistically the same
        fiber, not bit-identical noise.  That is the honest contract a
        real re-tapped interrogator offers too: the physical events are
        still there, the noise floor is fresh."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"resume offset {offset} must be >= 0")
        # Offset 0 is a plain (re)start: same stream as a fresh source.
        self._rng = np.random.default_rng(
            self._seed if offset == 0 else [self._seed, offset])
        self._pos = offset

    def close(self) -> None:
        pass


class FileTailSource:
    """Tail a growing raw float32 file.  Framing: one frame is
    ``channels`` consecutive float32 values sampled at one time instant
    (sample-major) — ``poll`` returns complete frames transposed to
    ``(channels, k)`` and carries partial trailing bytes to the next
    call."""

    def __init__(self, path: str, channels: int):
        self.channels = int(channels)
        self._frame_bytes = 4 * self.channels
        self._f = open(path, "rb")
        self._carry = b""

    def poll(self, max_samples: int) -> Optional[np.ndarray]:
        want = int(max_samples) * self._frame_bytes - len(self._carry)
        data = self._carry + (self._f.read(max(0, want)) or b"")
        n_frames = len(data) // self._frame_bytes
        if n_frames == 0:
            self._carry = data
            return None
        cut = n_frames * self._frame_bytes
        self._carry = data[cut:]
        frames = np.frombuffer(data[:cut], np.float32).reshape(
            n_frames, self.channels)
        return np.ascontiguousarray(frames.T)

    def resume_from(self, offset: int) -> None:
        """Seek to absolute sample ``offset`` (frame-addressed: byte
        position ``offset * 4 * channels``) and drop any carried
        partial frame."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"resume offset {offset} must be >= 0")
        self._f.seek(offset * self._frame_bytes)
        self._carry = b""

    def close(self) -> None:
        self._f.close()


#: ``SocketSource.resume_from`` wire handshake: 8-byte magic + one
#: big-endian uint64 absolute sample offset, sent consumer -> producer.
#: Opt-in — a plain frame sender never receives one (the consumer only
#: sends it when a supervisor explicitly requests a resume), and a
#: handshake-aware sender rewinds its cursor and resumes frames from
#: that sample.
RESUME_MAGIC = b"DASRESUM"
RESUME_FRAME_BYTES = len(RESUME_MAGIC) + 8


class SocketSource:
    """The file-tail framing over TCP: connect to ``host:port`` and
    drain whatever complete frames have arrived, without blocking."""

    def __init__(self, host: str, port: int, channels: int,
                 connect_timeout_s: float = 10.0):
        self.channels = int(channels)
        self._frame_bytes = 4 * self.channels
        self._sock = socketlib.create_connection(
            (host, int(port)), timeout=connect_timeout_s)
        self._sock.setblocking(False)
        self._carry = b""

    def poll(self, max_samples: int) -> Optional[np.ndarray]:
        budget = int(max_samples) * self._frame_bytes
        chunks = [self._carry]
        got = len(self._carry)
        while got < budget:
            try:
                piece = self._sock.recv(min(65536, budget - got))
            except BlockingIOError:
                break
            if not piece:  # peer closed; keep returning what we have
                break
            chunks.append(piece)
            got += len(piece)
        data = b"".join(chunks)
        n_frames = len(data) // self._frame_bytes
        if n_frames == 0:
            self._carry = data
            return None
        cut = n_frames * self._frame_bytes
        self._carry = data[cut:]
        frames = np.frombuffer(data[:cut], np.float32).reshape(
            n_frames, self.channels)
        return np.ascontiguousarray(frames.T)

    def resume_from(self, offset: int) -> None:
        """Request replay from absolute sample ``offset``: sends the
        :data:`RESUME_MAGIC` control frame upstream (the opt-in
        handshake — the peer must speak it) and drops any buffered
        partial frame so the next bytes received ARE sample ``offset``
        onward."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"resume offset {offset} must be >= 0")
        self._sock.sendall(RESUME_MAGIC
                           + offset.to_bytes(8, "big"))
        self._carry = b""

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# -- fleet fiber specs ---------------------------------------------------------

def source_from_spec(spec: dict, channels: int):
    """Instantiate a chunk source from its portable JSON spec — how a
    fleet controller hands a fiber to a worker (and to a DIFFERENT
    worker after migration or failover; the spec plus a resume offset
    is the fiber's whole identity).  Kinds: ``synthetic`` (``seed``,
    optional ``events`` rows ``[onset, duration, event,
    center_channel]``, ``nan_samples``, ``nan_channel``), ``tail``
    (``path``), ``connect`` (``host``, ``port``)."""
    kind = spec.get("kind")
    if kind == "synthetic":
        events = tuple(PlantedEvent(int(e[0]), int(e[1]), int(e[2]),
                                    int(e[3]))
                       for e in spec.get("events", ()))
        return SyntheticSource(channels, seed=int(spec.get("seed", 0)),
                               events=events,
                               nan_samples=spec.get("nan_samples", ()),
                               nan_channel=spec.get("nan_channel"))
    if kind == "tail":
        return FileTailSource(spec["path"], channels)
    if kind == "connect":
        return SocketSource(spec.get("host", "127.0.0.1"),
                            int(spec["port"]), channels)
    raise ValueError(f"unknown fiber spec kind {kind!r} — expected "
                     f"synthetic | tail | connect")
