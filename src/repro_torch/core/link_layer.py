"""PCIe 6.0 FLIT link layer: flit packing, FEC/CRC retry, credit flow control.

The seed modeled the whole PCIe link layer as one bandwidth constant.  This
module makes it a first-class subsystem, following Das Sharma's CXL
interconnect overview (arXiv 2306.11227):

  * **Flit packing** — PCIe 6.0 / CXL 3.x links carry fixed 256 B flits:
    236 B of TLP payload plus 6 B DLLP, 8 B CRC and 6 B FEC check symbols.
    PCIe 5 / CXL 2.0 links in CXL's 68 B flit mode carry 64 B slots with a
    2 B CRC and 2 B protocol-ID header.  A logical packet of ``n`` bytes
    therefore occupies ``ceil(n / payload) * size`` wire bytes.

  * **Lightweight FEC + CRC retry** — the 3-way interleaved FEC of PCIe 6.0
    adds a small fixed decode latency per hop (~2 ns).  Flits that fail CRC
    after FEC are replayed link-level with Go-Back-N: the failed flit and
    every flit in flight behind it retransmit.  Under a bit error rate
    ``ber`` the per-flit error probability is ``1 - (1 - ber)^bits`` and the
    expected transmissions per flit is ``(1 - p + p*W) / (1 - p)`` for a
    replay window of ``W`` flits.  The *expected* overhead is folded into
    serialization deterministically (as integer parts-per-million), which
    keeps the engine exact and bit-reproducible and makes goodput a
    monotone function of BER — what the sensitivity sweeps need.

  * **Credit-based flow control** — the receiver grants ``rx_credits`` flit
    buffers; the sender stalls when the in-flight window exceeds them.  A
    credit loop of round-trip ``credit_rtt_ps`` therefore caps sustained
    throughput at ``credits * flit_size / rtt`` regardless of raw lane
    speed — the classic bandwidth-delay-product bound, applied as a
    per-channel effective-bandwidth derate.

Lowering contract: everything a flit link does to traffic is expressed as
three per-channel integer tables (``flit_size``, ``flit_payload``,
``replay_ppm``) consumed by ``core.engine`` / ``core.ref_des`` during
serialization, plus an effective bandwidth and a fixed per-hop latency add.
``flit_mode="none"`` produces empty tables and reproduces the seed's
byte-exact schedules bit-for-bit.

  * **Stochastic reliability** (``FlitConfig(reliability="stochastic")``) —
    the expected-value replay model above is exact in the mean but blind to
    tails: every packet pays the same stretch, so p99 == p50 scaled.  The
    stochastic mode instead samples, per flit and per channel from a seeded
    stream at build time (like issue jitter), the actual Go-Back-N failure
    counts — landing as per-hop ``extra_wire_bytes`` — and **retraining
    stalls**: a flit failing ``retrain_threshold`` times consecutively drops
    the link into a microsecond-scale Recovery interval (per-hop
    ``retrain_after_ps``), during which the channel grants nothing — the
    per-channel ``down_until`` state the engine carries in its scan (its
    first stateful extension beyond FCFS).  Both tables ride in ``Hops``,
    not ``Channels``; at BER 0 the samples are all zero and the schedule
    equals the deterministic path exactly, and ``core.ref_des`` mirrors both
    effects so engine == oracle stays bit-exact for any fixed seed.

This is the PyTorch port's copy of ``repro.core.link_layer``.  Everything
here stays numpy — the seeded draws are numpy ``Generator`` streams, so the
sampled tables equal the reference's bit for bit — except the two functions
that build engine types (`apply_flit`, `apply_retrain_markers` /
`strip_retrain_markers`), which return torch tensors.  The flit-pack kernel
and the vmapped sweeps are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .calibration import (CRC_REPLAY_RTT_PS, FEC_LATENCY_PS, FLIT68_PAYLOAD_B,
                          FLIT68_SIZE_B, FLIT256_PAYLOAD_B, FLIT256_SIZE_B,
                          LINK_RETRAIN_PS)

PPM = 1_000_000
RELIABILITY_MODES = ("expected", "stochastic")
# Ceiling on the expected Go-Back-N replay overhead: 1000x extra
# transmissions per flit.  The expected-value model diverges as the flit
# error probability approaches 1, but a real link retrains long before
# that (see the lane-margining ROADMAP item); the clamp also keeps
# replay_ppm within the flit_pack kernel's int32 tables, and the engine's
# decomposed replay stretch (engine.wire_ser_ps) stays int64-exact with
# ppm at this clamp for serializations up to ~9.2e15 ps.
MAX_REPLAY_PPM = 1000 * PPM

# mode -> (flit size on the wire, TLP payload bytes per flit)
FLIT_GEOMETRY: dict[str, tuple[int, int]] = {
    "none": (0, 0),
    "flit68": (FLIT68_SIZE_B, FLIT68_PAYLOAD_B),      # PCIe 5 / CXL 2.0
    "flit256": (FLIT256_SIZE_B, FLIT256_PAYLOAD_B),   # PCIe 6 / CXL 3.x
}
FLIT_MODES = tuple(FLIT_GEOMETRY)


@dataclass(frozen=True)
class FlitConfig:
    """Link-layer configuration of one physical link (both directions).

    mode            "none" (byte-exact seed semantics) | "flit68" | "flit256".
    ber             residual bit error rate the CRC sees — i.e. *after* the
                    lightweight FEC has corrected what it can (FEC escapes).
                    Datasheet raw lane BERs (~1e-6 for PCIe 6.0) must be
                    mapped through the FEC correction model first; residual
                    rates are typically orders of magnitude lower.
    rx_credits      receiver buffer, in flits, granted to the sender.  The
                    default (256) covers the bandwidth-delay product of any
                    realistic lane rate at the default credit RTT, so credit
                    flow control only binds when a study shrinks it.
    credit_rtt_ps   credit-return loop latency (propagation + DLLP processing).
    retry_window    Go-Back-N replay window, in flits in flight.
    fec_ps          per-hop FEC decode latency; None = mode default
                    (lightweight FEC exists only in 256 B flit mode).
    reliability     "expected" — CRC replay folded into serialization as the
                    deterministic expected-value stretch (``replay_ppm``;
                    exact and monotone, what sweeps want);
                    "stochastic" — seeded per-flit Bernoulli replay sampled
                    at build time (`sample_replays`): per-packet replay
                    *counts* instead of a mean goodput scale, so tail
                    latency sees bursts, plus retraining stalls below.
    rel_seed        seed of the stochastic sampling stream.  Each channel
                    derives an independent substream from (rel_seed, channel
                    id), so a fixed seed gives one reproducible fault
                    history for the whole fabric.
    retrain_threshold  consecutive failed transmissions of one flit that
                    force link retraining (0 disables).  Only meaningful in
                    stochastic mode — the expected-value model clamps at
                    MAX_REPLAY_PPM instead (see its comment).
    retrain_ps      link-down interval per retraining event; None = the
                    calibrated microsecond-scale `LINK_RETRAIN_PS`.  While
                    down, the channel grants nothing (per-channel
                    ``down_until`` state carried in the engine scan); the
                    paired reverse direction of a full-duplex link goes
                    down with it (retraining re-equalizes the physical
                    link), mirrored onto the paired channel as zero-byte
                    link-down marker hops at build time.
    credit_dllp     model credit-return DLLPs as real traffic: every
                    ``rx_credits`` flits transmitted on a full-duplex flit
                    channel emit one ``CREDIT_DLLP_B``-byte hop on the
                    paired reverse channel (a real flit on the wire), so
                    credit starvation couples to reverse-direction
                    congestion.  Off (default), credits stay a pure
                    bandwidth cap — the byte-exact seed semantics.
    """

    mode: str = "none"
    ber: float = 0.0
    rx_credits: int = 256
    credit_rtt_ps: int = CRC_REPLAY_RTT_PS
    retry_window: int = 16
    fec_ps: int | None = None
    reliability: str = "expected"
    rel_seed: int = 0
    retrain_threshold: int = 0
    retrain_ps: int | None = None
    credit_dllp: bool = False

    def __post_init__(self):
        if self.mode not in FLIT_GEOMETRY:
            raise ValueError(f"unknown flit mode {self.mode!r}; "
                             f"expected one of {FLIT_MODES}")
        if not 0.0 <= self.ber < 1.0:
            raise ValueError(f"ber {self.ber} out of [0, 1)")
        if self.rx_credits < 1:
            raise ValueError("rx_credits must be >= 1")
        if self.reliability not in RELIABILITY_MODES:
            raise ValueError(f"unknown reliability {self.reliability!r}; "
                             f"expected one of {RELIABILITY_MODES}")
        if self.retrain_threshold < 0:
            raise ValueError("retrain_threshold must be >= 0")
        if self.retrain_ps is not None and self.retrain_ps < 0:
            raise ValueError("retrain_ps must be >= 0")

    @property
    def active(self) -> bool:
        return self.mode != "none"

    @property
    def geometry(self) -> tuple[int, int]:
        return FLIT_GEOMETRY[self.mode]

    @property
    def fec_latency_ps(self) -> int:
        if self.fec_ps is not None:
            return self.fec_ps
        return FEC_LATENCY_PS if self.mode == "flit256" else 0

    @property
    def stochastic(self) -> bool:
        return self.active and self.reliability == "stochastic"

    @property
    def retrain_down_ps(self) -> int:
        return LINK_RETRAIN_PS if self.retrain_ps is None else self.retrain_ps


def normalize(flit: "FlitConfig | str | None") -> FlitConfig:
    """Accept a FlitConfig, a mode string, or None (= byte-exact)."""
    if flit is None:
        return FlitConfig("none")
    if isinstance(flit, str):
        return FlitConfig(flit)
    return flit


# ---------------------------------------------------------------------------
# Flit packing
# ---------------------------------------------------------------------------

def wire_bytes(nbytes, mode: str):
    """Wire bytes of an ``nbytes`` logical packet: whole flits, incl. CRC/FEC.

    Accepts scalars or numpy arrays.  ``mode="none"`` is the identity.
    """
    size, payload = FLIT_GEOMETRY[mode]
    if size == 0:
        return nbytes
    return -(-np.asarray(nbytes) // payload) * size if np.ndim(nbytes) \
        else -(-nbytes // payload) * size


def flit_efficiency(mode: str) -> float:
    """Analytic zero-BER payload fraction of a fully packed flit stream."""
    size, payload = FLIT_GEOMETRY[mode]
    return 1.0 if size == 0 else payload / size


# ---------------------------------------------------------------------------
# FEC/CRC retry (Go-Back-N replay, expected-value model)
# ---------------------------------------------------------------------------

def flit_error_prob(ber: float, mode: str) -> float:
    """Probability one flit still fails CRC: 1 - (1-ber)^bits over the flit.

    ``ber`` is the residual post-FEC rate (see FlitConfig), so the geometry
    term is the whole flit (CRC covers every wire byte).
    """
    size, _ = FLIT_GEOMETRY[mode]
    if size == 0 or ber <= 0.0:
        return 0.0
    return -math.expm1(8 * size * math.log1p(-ber))


def replay_overhead_ppm(ber: float, mode: str, retry_window: int = 16) -> int:
    """Expected *extra* transmissions per flit, in parts-per-million.

    Go-Back-N with window W and flit error probability p retransmits, in
    expectation, ``E - 1 = p * W / (1 - p)`` extra flits per delivered flit
    (E = (1 - p + p*W)/(1 - p)).  Returned as an integer ppm so the engine
    can fold it into serialization without leaving int64 arithmetic; the
    divergence as p -> 1 is clamped at ``MAX_REPLAY_PPM`` (a link that bad
    retrains rather than replaying forever).
    """
    p = flit_error_prob(ber, mode)
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return MAX_REPLAY_PPM
    return min(int(round(p * max(retry_window, 1) / (1.0 - p) * PPM)),
               MAX_REPLAY_PPM)


def goodput_efficiency(mode: str, ber: float = 0.0,
                       retry_window: int = 16) -> float:
    """Payload fraction of wire time including expected CRC replays."""
    ppm = replay_overhead_ppm(ber, mode, retry_window)
    return flit_efficiency(mode) / (1.0 + ppm / PPM)


# ---------------------------------------------------------------------------
# Stochastic replay + retraining (seeded per-flit sampling, build time)
# ---------------------------------------------------------------------------

def _clamp_flit_p(p: float, retry_window: int) -> float:
    """The stochastic twin of the MAX_REPLAY_PPM divergence guard: cap the
    per-flit failure probability where the expected Go-Back-N extras per
    flit (W * p / (1 - p)) reach the expected-value model's ceiling — a
    link that bad retrains rather than replaying forever.  Also keeps the
    geometric success probability strictly positive once `flit_error_prob`
    rounds to 1.0."""
    max_fails = MAX_REPLAY_PPM / PPM / max(retry_window, 1)
    return min(p, max_fails / (1.0 + max_fails))


def retrain_event_prob(ber: float, mode: str, retrain_threshold: int,
                       retry_window: int = 16) -> float:
    """Probability one flit fails CRC ``retrain_threshold`` times in a row.

    Transmissions of one flit are independent Bernoulli(p) failures, so a
    run of R consecutive failures — the condition that drops the link into
    retraining — has probability p**R per flit, with p clamped exactly as
    `sample_replays` clamps it so the analytic helper matches the sampler
    in the high-BER regime.
    """
    if retrain_threshold <= 0:
        return 0.0
    p = _clamp_flit_p(flit_error_prob(ber, mode), retry_window)
    return p ** retrain_threshold


def sample_replays(n_flits: np.ndarray, p: float, retry_window: int,
                   retrain_threshold: int,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Sample one channel's per-hop Go-Back-N replay flits + retrain events.

    ``n_flits[i]`` is the flit count of hop ``i`` on this channel, in flat
    hop order (the deterministic sampling order for a fixed seed).  Per
    flit, the failed transmissions before CRC success are geometric with
    failure probability ``p``; each failure replays the ``retry_window``
    flits in flight behind it, so a hop of ``n`` flits carries
    ``W * NegBinomial(n, 1 - p)`` extra flit transmissions — whose mean,
    ``n * W * p / (1 - p)``, is exactly the expected-value model's
    ``replay_ppm`` stretch.

    Retraining events (a flit failing ``retrain_threshold`` times
    consecutively) are *coupled to the sampled replay total*: iid
    Geometric(p) per-flit failure counts are exactly (NegBinomial total,
    uniform composition over flits), so conditional on the hop's total
    failures ``f`` the probability any one flit reached ``R`` failures is
    ``prod_{j<R} (f-j)/(n+f-1-j)`` — events are drawn
    ``Binomial(n, that)``, clamped to the hard bound ``f // R``.  The
    unclamped marginal event rate is exactly ``n * p**R`` (the clamp only
    removes the rare Binomial overshoots past what the sampled failures
    can explain, shaving it slightly below), a hop can no longer retrain
    without having sampled the failures that caused it (the independence
    approximation this replaces allowed that), and the replay draw itself
    is byte-identical to before, so the stream is unchanged for any
    ``retrain_threshold`` sharing a seed.

    Returns ``(extra_flits, retrain_events)`` int64 arrays shaped like
    ``n_flits``.
    """
    n_flits = np.asarray(n_flits, dtype=np.int64)
    extra = np.zeros_like(n_flits)
    events = np.zeros_like(n_flits)
    if n_flits.size == 0 or p <= 0.0:
        return extra, events
    w = max(retry_window, 1)
    p = _clamp_flit_p(p, w)
    pos = n_flits > 0
    extra[pos] = rng.negative_binomial(n_flits[pos], 1.0 - p) * w
    if retrain_threshold > 0:
        n = n_flits[pos]
        f = extra[pos] // w                      # sampled failures per hop
        r = retrain_threshold
        q = np.ones(n.shape, dtype=np.float64)
        for j in range(r):
            q *= np.clip(f - j, 0, None) / np.maximum(n + f - 1 - j, 1)
        ev = rng.binomial(n, q)
        events[pos] = np.minimum(ev, f // r)
    return extra, events


def broadcast_reliability_tables(cfg: "FlitConfig", n_channels: int,
                                 link_mask: np.ndarray) -> dict:
    """One stochastic config broadcast into per-channel sampling tables.

    The kwargs of `sample_hop_tables` for a fabric whose link channels
    (``link_mask`` true) all run ``cfg`` — the single definition shared by
    the workload-level override path (`devices.build_workload(flit=...)`)
    and any caller resampling tables off an existing hop layout (e.g. a
    BER sweep).
    """
    size, payload = cfg.geometry
    return dict(
        stochastic=np.asarray(link_mask, bool),
        err_p=np.full(n_channels, flit_error_prob(cfg.ber, cfg.mode)),
        flit_size=np.full(n_channels, size, np.int64),
        flit_payload=np.full(n_channels, payload, np.int64),
        retry_window=np.full(n_channels, cfg.retry_window, np.int64),
        retrain_threshold=np.full(n_channels, cfg.retrain_threshold,
                                  np.int64),
        retrain_ps=np.full(n_channels, cfg.retrain_down_ps, np.int64),
        rel_seed=np.full(n_channels, cfg.rel_seed, np.int64),
    )


def channel_rng(rel_seed: int, channel: int) -> np.random.Generator:
    """The per-channel sampling stream: independent substreams per channel
    id, reproducible for a fixed ``rel_seed`` regardless of which other
    channels exist or sample first."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=int(rel_seed),
                               spawn_key=(int(channel),)))


def sample_hop_tables(chan: np.ndarray, nbytes: np.ndarray, valid: np.ndarray,
                      *, stochastic: np.ndarray, err_p: np.ndarray,
                      flit_size: np.ndarray, flit_payload: np.ndarray,
                      retry_window: np.ndarray, retrain_threshold: np.ndarray,
                      retrain_ps: np.ndarray,
                      rel_seed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sample the per-hop stochastic tables for a whole hop matrix.

    All per-channel arrays come from the `FabricGraph` lowering (or a
    broadcast workload-level override).  Returns ``(extra_wire_bytes,
    retrain_after_ps)`` int64 arrays of ``chan``'s shape: sampled replay
    wire bytes added to the hop's serialization, and the sampled link-down
    interval the channel enters when the hop departs (events x per-event
    retraining stall).
    """
    chan = np.asarray(chan)
    nbytes = np.asarray(nbytes, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    extra_wire = np.zeros(chan.shape, dtype=np.int64)
    retrain_after = np.zeros(chan.shape, dtype=np.int64)
    for c in np.where(np.asarray(stochastic, bool))[0]:
        payload = max(int(flit_payload[c]), 1)
        mask = (chan == c) & valid & (nbytes > 0)
        if not mask.any():
            continue
        n_flits = -(-nbytes[mask] // payload)
        extra, events = sample_replays(
            n_flits, float(err_p[c]), int(retry_window[c]),
            int(retrain_threshold[c]), channel_rng(int(rel_seed[c]), int(c)))
        extra_wire[mask] = extra * int(flit_size[c])
        retrain_after[mask] = events * int(retrain_ps[c])
    return extra_wire, retrain_after


# ---------------------------------------------------------------------------
# Full-duplex retraining mirror (link-down marker hops)
# ---------------------------------------------------------------------------
# Retraining re-equalizes the physical link, so BOTH directions of a
# full-duplex link stall together.  The engine's per-channel down-until
# state is segment-local (one channel per scan segment), so the reverse
# direction's stall is expressed as data: a zero-byte *link-down marker*
# hop on the paired channel, inserted right after the triggering hop.  A
# marker occupies nothing and turns nothing — it only pushes the paired
# channel's ``down_until`` to (its arrival + retrain_after_ps).  Markers
# are identified structurally: ``valid & nbytes == 0 & retrain_after_ps
# > 0`` (see `engine._one_round` / `ref_des.simulate_ref`).

def retrain_marker_mask(channel, nbytes, valid, retrain_after) -> np.ndarray:
    """Boolean mask of link-down marker hops in a hop matrix."""
    if retrain_after is None:
        return np.zeros(np.asarray(channel).shape, dtype=bool)
    return (np.asarray(valid, bool) & (np.asarray(nbytes) == 0)
            & (np.asarray(retrain_after) > 0))


def insert_retrain_markers(channel, nbytes, direction, row, fixed_after,
                           is_payload, valid, extra_wire, retrain_after,
                           chan_pair) -> tuple:
    """Insert a link-down marker after every hop that samples a retraining
    event on a channel with a full-duplex pair (``chan_pair[c] >= 0``).

    The trigger's ``fixed_after`` moves onto the marker so the marker
    arrives exactly at the trigger's departure (= the instant the link
    drops) and downstream arrivals are unchanged.  Returns the ten arrays
    with columns widened by the maximum per-row marker count; a hop matrix
    with no triggering hops is returned unchanged (bit-exact layout).
    """
    chan_pair = np.asarray(chan_pair)
    trigger = ((np.asarray(retrain_after) > 0) & np.asarray(valid, bool)
               & (np.asarray(nbytes) > 0)
               & (chan_pair[np.asarray(channel)] >= 0))
    maxk = int(trigger.sum(axis=1).max()) if trigger.any() else 0
    if maxk == 0:
        return (channel, nbytes, direction, row, fixed_after, is_payload,
                valid, extra_wire, retrain_after)
    n, h = np.asarray(channel).shape
    h2 = h + maxk
    out = dict(
        channel=np.full((n, h2), -1, np.int32),
        nbytes=np.zeros((n, h2), np.int64),
        direction=np.zeros((n, h2), np.int8),
        row=np.full((n, h2), -1, np.int32),
        fixed_after=np.zeros((n, h2), np.int64),
        is_payload=np.zeros((n, h2), bool),
        valid=np.zeros((n, h2), bool),
        extra_wire=np.zeros((n, h2), np.int64),
        retrain_after=np.zeros((n, h2), np.int64),
    )
    src = (channel, nbytes, direction, row, fixed_after, is_payload, valid,
           extra_wire, retrain_after)
    names = tuple(out)
    for j in range(n):
        k = 0
        for i in range(h):
            for name, arr in zip(names, src):
                out[name][j, k] = arr[j, i]
            k += 1
            if trigger[j, i]:
                out["channel"][j, k] = chan_pair[channel[j, i]]
                out["valid"][j, k] = True
                out["retrain_after"][j, k] = retrain_after[j, i]
                out["fixed_after"][j, k] = fixed_after[j, i]
                out["fixed_after"][j, k - 1] = 0
                k += 1
    return tuple(out[name] for name in names)


def remove_retrain_markers(channel, nbytes, direction, row, fixed_after,
                           is_payload, valid, extra_wire,
                           retrain_after) -> tuple:
    """Exact inverse of `insert_retrain_markers` (test/bench helper):
    drop marker columns, hand each marker's ``fixed_after`` back to its
    triggering hop, and left-justify to the original width."""
    marker = retrain_marker_mask(channel, nbytes, valid, retrain_after)
    if not marker.any():
        return (channel, nbytes, direction, row, fixed_after, is_payload,
                valid, extra_wire, retrain_after)
    n, h2 = np.asarray(channel).shape
    h = h2 - int(marker.sum(axis=1).max())
    out = dict(
        channel=np.full((n, h), -1, np.int32),
        nbytes=np.zeros((n, h), np.int64),
        direction=np.zeros((n, h), np.int8),
        row=np.full((n, h), -1, np.int32),
        fixed_after=np.zeros((n, h), np.int64),
        is_payload=np.zeros((n, h), bool),
        valid=np.zeros((n, h), bool),
        extra_wire=np.zeros((n, h), np.int64),
        retrain_after=np.zeros((n, h), np.int64),
    )
    src = (channel, nbytes, direction, row, fixed_after, is_payload, valid,
           extra_wire, retrain_after)
    names = tuple(out)
    for j in range(n):
        k = 0
        for i in range(h2):
            if marker[j, i]:
                out["fixed_after"][j, k - 1] = fixed_after[j, i]
                continue
            if k >= h:
                break
            for name, arr in zip(names, src):
                out[name][j, k] = arr[j, i]
            k += 1
    return tuple(out[name] for name in names)


def _hops_arrays(hops) -> tuple:
    """The nine insert/remove arrays of an engine ``Hops`` as host numpy,
    in contract order (missing reliability tables become zeros)."""
    from .engine import to_host

    n, h = hops.channel.shape
    return (to_host(hops.channel), to_host(hops.nbytes),
            to_host(hops.direction), to_host(hops.row),
            to_host(hops.fixed_after_ps), to_host(hops.is_payload),
            to_host(hops.valid),
            np.zeros((n, h), np.int64) if hops.extra_wire_bytes is None
            else to_host(hops.extra_wire_bytes),
            np.zeros((n, h), np.int64) if hops.retrain_after_ps is None
            else to_host(hops.retrain_after_ps))


def _hops_from_arrays(arrs, device) -> "object":
    from .engine import Hops, to_device

    chan, nbytes, direction, row, fixed, pay, valid, extra, retrain = arrs
    return Hops(*(to_device(a, device) for a in
                  (chan, nbytes, direction, row, fixed, pay, valid, extra,
                   retrain)))


def apply_retrain_markers(hops, chan_pair) -> "object":
    """`insert_retrain_markers` at the engine-``Hops`` level; the result
    lies on the device of ``hops.channel``."""
    return _hops_from_arrays(
        insert_retrain_markers(*_hops_arrays(hops), chan_pair),
        hops.channel.device)


def strip_retrain_markers(hops) -> "object":
    """`remove_retrain_markers` at the engine-``Hops`` level (the exact
    inverse of the build path's marker insertion — test/bench helper)."""
    return _hops_from_arrays(remove_retrain_markers(*_hops_arrays(hops)),
                             hops.channel.device)


# ---------------------------------------------------------------------------
# Credit-based flow control
# ---------------------------------------------------------------------------

def credit_limited_MBps(bw_MBps: int, cfg: FlitConfig) -> int:
    """Sustained-rate cap from the credit loop: credits*flit_size per RTT.

    With enough rx credits to cover the bandwidth-delay product this returns
    ``bw_MBps`` unchanged; a shallow receiver buffer caps the link below its
    lane rate (the knob the rx-buffer sizing studies sweep).
    """
    size, _ = cfg.geometry
    if size == 0 or cfg.credit_rtt_ps <= 0:
        return bw_MBps
    # credits * size bytes per rtt ps -> MB/s: bytes * 1e12 / (rtt * 1e6)
    cap = cfg.rx_credits * size * PPM // cfg.credit_rtt_ps
    return min(bw_MBps, max(int(cap), 1))


# ---------------------------------------------------------------------------
# Lowering to engine channel tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LoweredLink:
    """Per-direction channel entries a flit link contributes to the graph.

    The first five fields are the deterministic engine tables (the
    expected-value contract).  The reliability block parameterizes
    build-time stochastic sampling (`sample_hop_tables`); it never enters
    the engine's channel arrays — sampled outcomes land in per-hop ``Hops``
    tables instead, so a BER sweep can stack the sampled tables.  In stochastic mode ``replay_ppm``
    is 0: the sampled per-flit replays replace the expected-value stretch
    (double counting would bias goodput low).
    """

    eff_bw_MBps: int      # credit-capped serialization bandwidth
    extra_fixed_ps: int   # FEC decode latency added to per-hop fixed latency
    flit_size: int        # 0 = byte-exact channel
    flit_payload: int
    replay_ppm: int       # expected CRC-replay overhead (Go-Back-N)
    stochastic: bool = False   # sample per-flit replays at build time
    flit_err_p: float = 0.0    # per-flit CRC failure probability
    retry_window: int = 0      # Go-Back-N window (flits replayed per failure)
    retrain_threshold: int = 0  # consecutive failures forcing retraining
    retrain_ps: int = 0        # link-down interval per retraining event
    rel_seed: int = 0          # sampling stream seed
    credit_dllp: bool = False  # emit credit-return DLLP reverse hops
    credit_window: int = 0     # flits per credit-return DLLP


def lower_link(bw_MBps: int, flit: "FlitConfig | str | None") -> LoweredLink:
    """Lower one link's flit config into engine channel-table entries."""
    cfg = normalize(flit)
    if not cfg.active:
        return LoweredLink(bw_MBps, 0, 0, 0, 0)
    size, payload = cfg.geometry
    return LoweredLink(
        eff_bw_MBps=credit_limited_MBps(bw_MBps, cfg),
        extra_fixed_ps=cfg.fec_latency_ps,
        flit_size=size,
        flit_payload=payload,
        replay_ppm=0 if cfg.stochastic
        else replay_overhead_ppm(cfg.ber, cfg.mode, cfg.retry_window),
        stochastic=cfg.stochastic,
        flit_err_p=flit_error_prob(cfg.ber, cfg.mode) if cfg.stochastic
        else 0.0,
        retry_window=cfg.retry_window,
        retrain_threshold=cfg.retrain_threshold if cfg.stochastic else 0,
        retrain_ps=cfg.retrain_down_ps if cfg.stochastic else 0,
        rel_seed=cfg.rel_seed,
        credit_dllp=cfg.credit_dllp,
        credit_window=max(cfg.rx_credits, 1),
    )


def apply_flit(channels, link_mask: np.ndarray, flit: "FlitConfig | str | None"):
    """Override every masked channel of an engine ``Channels`` with ``flit``.

    The workload-level override path (`devices.build_workload(flit=...)`):
    returns a new Channels whose flit tables are set on link channels
    (``link_mask`` true) and zero elsewhere (service channels stay
    byte-exact).  ``flit=None``/"none" returns ``channels`` unchanged — the
    seed's structurally identical byte-exact path.  The tables lie on the
    device of ``channels.bw_MBps``.
    """
    import torch

    from .engine import Channels

    cfg = normalize(flit)
    if not cfg.active:
        return channels
    size, payload = cfg.geometry
    # stochastic reliability replaces the expected stretch with sampled
    # per-hop tables (devices.build_workload), so the channel ppm stays 0
    ppm = 0 if cfg.stochastic \
        else replay_overhead_ppm(cfg.ber, cfg.mode, cfg.retry_window)
    mask = torch.as_tensor(np.asarray(link_mask, bool),
                           device=channels.bw_MBps.device)
    bw = torch.where(
        mask,
        torch.clamp_max(channels.bw_MBps,
                        credit_limited_MBps(1 << 40, cfg)),
        channels.bw_MBps,
    )
    zeros = torch.zeros_like(channels.bw_MBps)
    return Channels(
        bw_MBps=bw,
        turnaround_ps=channels.turnaround_ps,
        row_hit_ps=channels.row_hit_ps,
        row_miss_ps=channels.row_miss_ps,
        flit_size=torch.where(mask, size, zeros),
        flit_payload=torch.where(mask, payload, zeros),
        replay_ppm=torch.where(mask, ppm, zeros),
    )


# Ready-made configurations for the paper's studied link generations.
PCIE5_FLIT = FlitConfig(mode="flit68")
PCIE6_FLIT = FlitConfig(mode="flit256")
