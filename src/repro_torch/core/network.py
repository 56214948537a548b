"""Time-varying network model with per-transfer bandwidth reservation.

This is the substrate the MLfabric scheduler (paper §5) reasons over.  Every
host has an independent *uplink* and *downlink* (the paper treats incoming
and outgoing links independently, §7) connected through a congestion-free
core (the paper's evaluation assumption).  Residual capacity of a link is a
piecewise-constant function of time; reserving a transfer consumes the
bottleneck residual bandwidth along its path, exactly as in Fig. 4(b)/(c).

Two structural properties matter for planner scale (DESIGN.md §11):

* ``Timeline`` mutations are *windowed*: ``add`` touches only the segments
  overlapping ``[t0, t1)`` and re-coalesces just that window, instead of the
  previous whole-list rebuild, so a reservation costs O(log s + w) for s
  stored segments and w touched segments.
* Planner look-aheads use :meth:`NetworkState.overlay` — a copy-on-write
  delta view that copies a link ``Timeline`` only when it is first written —
  instead of deep-copying every host timeline per candidate (O(changes),
  not O(U)).  Path bottlenecks are walked lazily with a two-iterator merge
  (:func:`make_profile_links`) rather than materializing the all-breakpoints
  ``Timeline.minimum``.

``Timeline`` separately tracks the link's *base* NIC rate so that a
``set_rate_from`` (a ``BandwidthTrace`` / N-setting event) re-applies live
reservations on top of the new rate instead of silently truncating them
(which used to mint phantom bandwidth when the reservation was later
released).  A rate drop below the reserved sum leaves the stored residual
negative — queries clamp to zero, and releases restore exactly.

Units: bytes and bytes/second.  Helpers for Gbps / MB are at module bottom.
"""

from __future__ import annotations

import bisect
import itertools
import math
from dataclasses import dataclass, field
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

INF = math.inf
_EPS = 1e-9
_REL_EPS = 1e-9     # relative rate tolerance for segment coalescing
_GUARD_REL = 1e-6   # relative over-reservation guard in Timeline.add


class Timeline:
    """A piecewise-constant rate function over ``[0, inf)``.

    Stored as parallel bisect-indexed lists of breakpoint times and the
    *residual* rate that holds from each breakpoint until the next (the last
    rate extends to infinity).  ``_bt``/``_br`` track the link's base NIC
    rate the same way; ``base - residual`` at any instant is the live
    reservation load, which ``set_rate_from`` preserves across NIC rate
    changes.  Residuals may go negative internally (rate dropped below the
    reserved sum); every query clamps to zero.
    """

    __slots__ = ("times", "rates", "_bt", "_br")

    def __init__(self, rate: float = 0.0):
        r = float(rate)
        self.times: List[float] = [0.0]
        self.rates: List[float] = [r]
        self._bt: List[float] = [0.0]
        self._br: List[float] = [r]

    # ------------------------------------------------------------------ #
    # construction / copying
    # ------------------------------------------------------------------ #
    def copy(self) -> "Timeline":
        t = Timeline.__new__(Timeline)
        t.times = list(self.times)
        t.rates = list(self.rates)
        t._bt = list(self._bt)
        t._br = list(self._br)
        return t

    @classmethod
    def from_segments(cls, segments: Iterable[Tuple[float, float]]) -> "Timeline":
        """Build from ``(start_time, rate)`` pairs; rate holds until next."""
        tl = cls(0.0)
        for t, r in segments:
            tl.set_rate_from(t, r)
        return tl

    # ------------------------------------------------------------------ #
    # queries (all clamp negative residuals to zero)
    # ------------------------------------------------------------------ #
    def _idx(self, t: float) -> int:
        """Index of the segment that contains time ``t``."""
        return bisect.bisect_right(self.times, t) - 1

    def rate_at(self, t: float) -> float:
        r = self.rates[self._idx(t)]
        return r if r > 0.0 else 0.0

    def base_rate_at(self, t: float) -> float:
        """The NIC rate (ignoring reservations) at time ``t``."""
        return self._br[bisect.bisect_right(self._bt, t) - 1]

    def segments(self, t_from: float = 0.0) -> Iterator[Tuple[float, float, float]]:
        """Yield ``(t0, t1, rate)``; the final segment has ``t1 == inf``."""
        i = self._idx(t_from)
        n = len(self.times)
        while i < n:
            t0 = max(self.times[i], t_from)
            t1 = self.times[i + 1] if i + 1 < n else INF
            r = self.rates[i]
            yield (t0, t1, r if r > 0.0 else 0.0)
            i += 1

    def integrate(self, t0: float, t1: float) -> float:
        """Total capacity (bytes) available in ``[t0, t1]``."""
        total = 0.0
        for s0, s1, r in self.segments(t0):
            if s0 >= t1:
                break
            total += r * (min(s1, t1) - s0)
        return total

    def time_to_consume(self, t_start: float, size: float) -> float:
        """Earliest ``t`` such that ``integrate(t_start, t) >= size``.

        Returns ``inf`` when the timeline can never deliver ``size`` bytes.
        Tolerances are relative to the transfer size and the link's rate
        scale — absolute epsilons vanish against byte counts ~1e8.
        """
        if size <= 0:
            return t_start
        byte_tol = _EPS + _REL_EPS * size
        remaining = size
        for t0, t1, r in self.segments(t_start):
            if r > _EPS:
                cap = r * (t1 - t0)
                if cap >= remaining - byte_tol:
                    return t0 + remaining / r
                remaining -= cap
        return INF

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #
    def _ensure_breakpoint(self, t: float) -> int:
        """Insert a breakpoint at ``t`` (if absent); return its index."""
        i = self._idx(t)
        if self.times[i] == t:
            return i
        self.times.insert(i + 1, t)
        self.rates.insert(i + 1, self.rates[i])
        return i + 1

    def set_rate_from(self, t: float, rate: float) -> None:
        """Change the link's base NIC rate to ``rate`` for all times ``>= t``.

        Live reservations are preserved: for every residual segment at or
        after ``t``, the reserved load ``base - residual`` is re-subtracted
        from the new rate.  If the new rate is below the reserved load the
        stored residual goes negative (queries clamp to zero) so that a
        later ``release`` restores exactly the new base — capacity is
        conserved across mid-transfer bandwidth changes.
        """
        rate = float(rate)
        self._ensure_breakpoint(t)
        # split the residual at every base breakpoint after t, so each
        # residual segment in [t, inf) sees a single base rate
        for bt in list(self._bt):
            if bt > t:
                self._ensure_breakpoint(bt)
        i = bisect.bisect_right(self.times, t) - 1
        for k in range(i, len(self.times)):
            reserved = self.base_rate_at(self.times[k]) - self.rates[k]
            self.rates[k] = rate - reserved
        # base := rate from t on
        bi = bisect.bisect_right(self._bt, t) - 1
        if self._bt[bi] == t:
            del self._bt[bi + 1:]
            del self._br[bi + 1:]
            self._br[bi] = rate
            if bi > 0 and self._br[bi - 1] == rate:
                del self._bt[bi:]
                del self._br[bi:]
        else:
            del self._bt[bi + 1:]
            del self._br[bi + 1:]
            if self._br[bi] != rate:
                self._bt.append(t)
                self._br.append(rate)
        self._coalesce()

    def add(self, t0: float, t1: float, delta: float,
            allow_deficit: bool = False) -> None:
        """Add ``delta`` to the rate over ``[t0, t1)`` (negative = reserve).

        The over-reservation guard is relative: fp noise on a 10 Gbps link
        is ~1e2 B/s absolute, so a fixed threshold either rejects valid
        releases or admits real over-subscription depending on scale.
        ``allow_deficit`` disables the guard for callers that *knowingly*
        oversubscribe — the simulator enacting a plan computed on a lagged
        monitor view after the real NIC rate dropped.  The deficit is
        stored as a negative residual (queries clamp to zero) so a later
        ``release`` still balances exactly.
        """
        if t1 <= t0 or delta == 0.0:
            return
        i = self._ensure_breakpoint(t0)
        j = self._ensure_breakpoint(t1) if t1 != INF else len(self.times)
        guard = not allow_deficit and delta < 0.0
        thr = -(_EPS + _GUARD_REL * -delta) if guard else 0.0
        rates = self.rates
        for k in range(i, j):
            r = rates[k]
            nr = r + delta
            if guard and nr < thr and r >= 0.0 and \
                    nr < -(_EPS + _GUARD_REL * r):
                raise ValueError(
                    f"over-reserved link: rate {r} + {delta} < 0 "
                    f"at t={self.times[k]}"
                )
            rates[k] = nr
        self._coalesce_window(i, j)

    def subtract_profile(self, profile: "Profile",
                         allow_deficit: bool = False) -> None:
        for t0, t1, r in profile.chunks:
            self.add(t0, t1, -r, allow_deficit=allow_deficit)

    def add_profile(self, profile: "Profile") -> None:
        for t0, t1, r in profile.chunks:
            self.add(t0, t1, r)

    @staticmethod
    def _close(a: float, b: float) -> bool:
        return abs(a - b) <= _EPS + _REL_EPS * max(abs(a), abs(b))

    def _coalesce(self) -> None:
        """Merge adjacent segments with (numerically) equal rates.

        Equality is *relative*: reservation/release round-trips leave the
        restored rate off by float rounding (~1e-7 absolute at 10 Gbps),
        far above any absolute epsilon small enough to separate real
        rates.  Without the relative test, long churn scenarios grow the
        segment list without bound — every later ``bisect`` and segment
        walk degrades linearly with the garbage (bounded growth is pinned
        by ``tests/test_network.py``).
        """
        nt, nr = [self.times[0]], [self.rates[0]]
        for t, r in zip(self.times[1:], self.rates[1:]):
            if not self._close(r, nr[-1]):
                nt.append(t)
                nr.append(r)
        self.times, self.rates = nt, nr

    def _coalesce_window(self, i: int, j: int) -> None:
        """Coalesce only segments ``[i-1, j]`` after a windowed mutation.

        A timeline that is coalesced outside the window stays coalesced:
        ``add`` shifts the window's rates by a constant, which preserves
        interior inequality up to the relative tolerance, and the window's
        two boundary pairs are re-checked here.  The scan is inlined and
        exits without allocating in the (overwhelmingly common) case where
        nothing merges — this runs once per reservation chunk.
        """
        rates = self.rates
        lo = i - 1 if i > 0 else 0
        n1 = len(rates) - 1
        hi = j if j < n1 else n1
        k = lo
        while k < hi:
            a = rates[k]
            b = rates[k + 1]
            d = a - b
            if d < 0.0:
                d = -d
            if a < 0.0:
                a = -a
            if b < 0.0:
                b = -b
            if d <= _EPS + _REL_EPS * (a if a > b else b):
                break
            k += 1
        else:
            return
        nt, nr = [self.times[lo]], [rates[lo]]
        for k in range(lo + 1, hi + 1):
            if not self._close(rates[k], nr[-1]):
                nt.append(self.times[k])
                nr.append(rates[k])
        self.times[lo:hi + 1] = nt
        self.rates[lo:hi + 1] = nr

    def forget_before(self, t: float) -> None:
        """Drop breakpoints strictly before ``t`` (the rate at ``t``
        extends back to 0).

        Once simulation time passes ``t``, no query ever looks left of it;
        the dead breakpoints only slow down ``bisect``.  Releases of
        transfers that started before ``t`` still work: their past chunks
        land in the (never again queried) merged head segment.
        """
        i = self._idx(t)
        if i > 0:
            self.times = [0.0] + self.times[i + 1:]
            self.rates = self.rates[i:]
            self._coalesce()
        bi = bisect.bisect_right(self._bt, t) - 1
        if bi > 0:
            self._bt = [0.0] + self._bt[bi + 1:]
            self._br = self._br[bi:]

    # ------------------------------------------------------------------ #
    # combination
    # ------------------------------------------------------------------ #
    @staticmethod
    def minimum(timelines: Sequence["Timeline"]) -> "Timeline":
        """Piecewise minimum of several timelines (path bottleneck, Fig 4b).

        Built with a lazy merge walk over the inputs' segments — a single
        pass over O(sum of segments), not the old all-breakpoints union
        with a ``rate_at`` probe per timeline per breakpoint.
        """
        assert timelines
        if len(timelines) == 1:
            return timelines[0].copy()
        out = Timeline.__new__(Timeline)
        out.times, out.rates = [], []
        for t0, _t1, r in merged_min_segments(timelines, 0.0):
            if not out.rates or not Timeline._close(r, out.rates[-1]):
                out.times.append(t0)
                out.rates.append(r)
        out._bt = list(out.times)
        out._br = list(out.rates)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        segs = ", ".join(f"[{t:.3g}:{r:.3g}]" for t, r in zip(self.times, self.rates))
        return f"Timeline({segs})"


def merged_min_segments(timelines: Sequence[Timeline],
                        t_from: float) -> Iterator[Tuple[float, float, float]]:
    """Lazily yield ``(t0, t1, min_rate)`` over several timelines.

    Advances one iterator per timeline in lockstep (smallest ``t1`` first);
    never materializes the breakpoint union.  Rates are clamped ``>= 0`` by
    the underlying :meth:`Timeline.segments`.
    """
    iters = [tl.segments(t_from) for tl in timelines]
    cur = [next(it) for it in iters]       # every timeline covers [t_from, inf)
    t = t_from
    while True:
        t_next = min(c[1] for c in cur)
        yield (t, t_next, min(c[2] for c in cur))
        if t_next == INF:
            return
        t = t_next
        for k, c in enumerate(cur):
            if c[1] <= t_next:
                cur[k] = next(iters[k])


@dataclass
class Profile:
    """A concrete bandwidth usage profile: list of ``(t0, t1, rate)`` chunks."""

    chunks: List[Tuple[float, float, float]] = field(default_factory=list)

    @property
    def t_start(self) -> float:
        return self.chunks[0][0] if self.chunks else INF

    @property
    def t_end(self) -> float:
        return self.chunks[-1][1] if self.chunks else INF

    @property
    def size(self) -> float:
        return sum((t1 - t0) * r for t0, t1, r in self.chunks)


def _profile_from_segments(segs: Iterator[Tuple[float, float, float]],
                           t_avail: float, size: float) -> Optional[Profile]:
    if size <= 0:
        return Profile([(t_avail, t_avail, 0.0)])
    # the byte comparison is relative to the transfer size (fp error in
    # ``cap`` is ~1e-8 * size, dwarfing any absolute epsilon at GB scale);
    # the rate floor stays absolute — an arbitrarily slow link is still a
    # usable link, and fully-consumed residuals are exactly zero
    byte_tol = _EPS + _REL_EPS * size
    chunks: List[Tuple[float, float, float]] = []
    remaining = size
    for t0, t1, r in segs:
        if r <= _EPS:
            continue
        cap = r * (t1 - t0)
        if cap >= remaining - byte_tol:
            # the closing chunk must not overshoot the segment boundary:
            # when the byte tolerance closes the profile, remaining/r can
            # exceed t1 - t0 by a few ulps, and the overhang would reserve
            # this segment's rate inside the *next* (possibly slower) one
            t_end = t0 + remaining / r
            chunks.append((t0, min(t_end, t1), r))
            return Profile(chunks)
        chunks.append((t0, t1, r))
        remaining -= cap
    return None


def make_profile(residual: Timeline, t_avail: float, size: float) -> Optional[Profile]:
    """Greedy maximal-rate transfer profile over ``residual`` (Fig. 4(b)).

    The transfer uses the full bottleneck residual bandwidth at every instant
    from ``t_avail`` until ``size`` bytes have moved.  Returns ``None`` if the
    residual can never carry ``size`` bytes.
    """
    return _profile_from_segments(residual.segments(t_avail), t_avail, size)


def make_profile_links(links: Sequence[Timeline], t_avail: float,
                       size: float) -> Optional[Profile]:
    """Greedy maximal-rate profile over the lazy min of several links.

    The planner hot path: equivalent to
    ``make_profile(Timeline.minimum(links), ...)`` but never materializes
    the combined timeline — it stops walking as soon as the profile closes.
    """
    if not links:
        return Profile([(t_avail, t_avail, 0.0)]) if size <= 0 else \
            Profile([(t_avail, t_avail, INF)])
    if len(links) == 2:
        return _profile_min2(links[0], links[1], t_avail, size)
    if len(links) == 1:
        segs = links[0].segments(t_avail)
    else:
        segs = merged_min_segments(links, t_avail)
    return _profile_from_segments(segs, t_avail, size)


def _profile_min2(A: Timeline, B: Timeline, t_avail: float,
                  size: float) -> Optional[Profile]:
    """Two-link specialization of :func:`make_profile_links`.

    Every path in the host/uplink-downlink model has exactly two links, so
    this two-pointer walk over the raw segment lists is the planner's
    innermost loop — same semantics as the generator-based generic walk,
    without generator frames or per-segment tuple allocation.
    """
    if size <= 0:
        return Profile([(t_avail, t_avail, 0.0)])
    byte_tol = _EPS + _REL_EPS * size
    at, ar = A.times, A.rates
    bt, br = B.times, B.rates
    na, nb = len(at), len(bt)
    ia = bisect.bisect_right(at, t_avail) - 1
    ib = bisect.bisect_right(bt, t_avail) - 1
    t0 = t_avail
    remaining = size
    chunks: List[Tuple[float, float, float]] = []
    while True:
        r = ar[ia]
        rb_ = br[ib]
        if rb_ < r:
            r = rb_
        ta1 = at[ia + 1] if ia + 1 < na else INF
        tb1 = bt[ib + 1] if ib + 1 < nb else INF
        t1 = ta1 if ta1 < tb1 else tb1
        if r > _EPS:
            cap = r * (t1 - t0)
            if cap >= remaining - byte_tol:
                t_end = t0 + remaining / r
                chunks.append((t0, t_end if t_end < t1 else t1, r))
                return Profile(chunks)
            chunks.append((t0, t1, r))
            remaining -= cap
        if t1 == INF:
            return None
        if ta1 <= t1:
            ia += 1
        if tb1 <= t1:
            ib += 1
        t0 = t1


# --------------------------------------------------------------------------- #
# network state
# --------------------------------------------------------------------------- #
@dataclass
class Transfer:
    """A scheduled transfer with the reserved per-link usage profile."""

    uid: int
    src: str
    dst: str
    size: float
    t_avail: float
    profile: Profile
    # per-segment binding-link attribution ``[(t0, t1, link_label)]``,
    # populated by :meth:`NetworkState.reserve` only when the state's
    # ``attribution`` flag is on (DESIGN.md §14); ``None`` otherwise
    bottlenecks: Optional[List[Tuple[float, float, str]]] = None

    @property
    def t_start(self) -> float:
        return self.profile.t_start

    @property
    def t_end(self) -> float:
        return self.profile.t_end


def attribute_profile(profile: Profile, links: Sequence[Timeline],
                      labels: Sequence[str]) -> List[Tuple[float, float, str]]:
    """Name the binding link for every segment of a reserved profile.

    The fluid min-walk (:func:`_profile_min2`) breaks chunks at every
    breakpoint of every path link, so within a chunk each link's residual
    rate is constant and the chunk rate equals the minimum — the argmin
    link is the *binding bottleneck* for that segment.  Must be called on
    the pre-reservation timelines (i.e. before ``commit_transfer``
    subtracts the profile).  Stall gaps between chunks (some link at zero
    residual) are attributed to the link with the smaller residual at the
    gap start.  Consecutive same-label segments are merged; the result
    covers ``[t_start, t_end]`` contiguously.
    """
    if not links or not profile.chunks:
        return []
    out: List[Tuple[float, float, str]] = []

    def push(t0: float, t1: float, label: str) -> None:
        if t1 <= t0:
            return
        if out and out[-1][2] == label and out[-1][1] >= t0:
            out[-1] = (out[-1][0], t1, label)
        else:
            out.append((t0, t1, label))

    prev_end: Optional[float] = None
    for t0, t1, _r in profile.chunks:
        if prev_end is not None and t0 > prev_end:
            # stall: at least one link had no residual over the gap
            rates = [lk.rate_at(prev_end) for lk in links]
            push(prev_end, t0, labels[rates.index(min(rates))])
        rates = [lk.rate_at(t0) for lk in links]
        push(t0, t1, labels[rates.index(min(rates))])
        prev_end = t1
    return out


class NetworkState:
    """Hosts with independent up/down links and a congestion-free core.

    ``reserve`` mutates residual capacity; ``transfer_time`` is a pure query.
    Planner look-aheads (Alg. 2 line 8, Alg. 3 case evaluation) use
    :meth:`overlay` — an O(changes) copy-on-write view — instead of
    :meth:`copy`, which deep-copies every host timeline.
    """

    # when True, ``reserve`` tags each Transfer with per-segment
    # binding-link attribution (DESIGN.md §14).  Class attribute so
    # planner overlays and copies inherit the default (off) — only the
    # simulator's *actual* network opts in, keeping planner look-aheads
    # and the golden traces untouched.
    attribution = False

    def __init__(self, hosts: Iterable[str], default_bw: float):
        hosts = list(hosts)
        self.up: Dict[str, Timeline] = {h: Timeline(default_bw) for h in hosts}
        self.down: Dict[str, Timeline] = {h: Timeline(default_bw) for h in hosts}
        self._uid = itertools.count()

    # -- admin ----------------------------------------------------------- #
    def add_host(self, host: str, bw: float) -> None:
        self.up[host] = Timeline(bw)
        self.down[host] = Timeline(bw)

    def remove_host(self, host: str) -> None:
        """Drop a departed host's timelines (WorkerLeave path).

        Without this, ``hosts()``/``copy()``/``compact()`` grow
        monotonically under churn.  Call only after in-flight transfers
        touching the host have been released or re-pointed.
        """
        self.up.pop(host, None)
        self.down.pop(host, None)

    def hosts(self) -> List[str]:
        return list(self.up)

    def copy(self) -> "NetworkState":
        ns = NetworkState.__new__(NetworkState)
        ns.up = {h: t.copy() for h, t in self.up.items()}
        ns.down = {h: t.copy() for h, t in self.down.items()}
        ns._uid = self._uid  # shared counter: uids stay unique across copies
        return ns

    def overlay(self) -> "NetworkOverlay":
        """An O(1) copy-on-write view for planner look-aheads.

        Reservations recorded on the overlay copy only the touched link
        timelines; the base is never mutated.  Overlays chain (an overlay
        of an overlay), which is how the incremental planner keeps a
        growing committed prefix without ever copying the full fleet.
        Do not mutate the base while a live overlay still reads it.
        """
        return NetworkOverlay(self)

    def set_bandwidth(self, host: str, t: float, up: Optional[float] = None,
                      down: Optional[float] = None) -> None:
        """Change a host NIC's rate from time ``t`` on (paper's N settings)."""
        if up is not None:
            self._wup(host).set_rate_from(t, up)
        if down is not None:
            self._wdown(host).set_rate_from(t, down)

    # -- writable link accessors (overridden by NetworkOverlay) ---------- #
    def _wup(self, host: str) -> Timeline:
        return self.up[host]

    def _wdown(self, host: str) -> Timeline:
        return self.down[host]

    def _wpath(self, src: str, dst: str) -> List[Timeline]:
        if src == dst:
            return []
        return [self._wup(src), self._wdown(dst)]

    # -- path model ------------------------------------------------------ #
    def path(self, src: str, dst: str) -> List[Timeline]:
        if src == dst:
            return []
        return [self.up[src], self.down[dst]]

    def residual(self, src: str, dst: str) -> Timeline:
        links = self.path(src, dst)
        if not links:
            return Timeline(INF)
        return Timeline.minimum(links)

    # -- queries ---------------------------------------------------------- #
    def transfer_time(self, src: str, dst: str, size: float,
                      t_avail: float) -> float:
        """Completion time of a maximal-rate transfer; pure query (no reserve)."""
        prof = make_profile_links(self.path(src, dst), t_avail, size)
        return prof.t_end if prof is not None else INF

    # -- mutation ---------------------------------------------------------- #
    def reserve(self, src: str, dst: str, size: float, t_avail: float) -> Transfer:
        """Reserve bottleneck bandwidth for the transfer (Fig. 4(c))."""
        tr = self.plan_transfer(src, dst, size, t_avail)
        if tr is None:
            raise RuntimeError(f"transfer {src}->{dst} of {size}B can never finish")
        if self.attribution and src != dst:
            # must run pre-commit: the argmin over residual rates below is
            # only the binding link while the profile is not yet subtracted
            tr.bottlenecks = attribute_profile(
                tr.profile, self.path(src, dst),
                (f"{src}:up", f"{dst}:down"))
        self.commit_transfer(tr)
        return tr

    def plan_transfer(self, src: str, dst: str, size: float,
                      t_avail: float) -> Optional[Transfer]:
        """Profile a transfer WITHOUT reserving (``None`` if unfinishable).

        Pairs with :meth:`commit_transfer`; lets planners inspect the
        completion time and reserve without recomputing the profile.
        """
        prof = make_profile_links(self.path(src, dst), t_avail, size)
        if prof is None:
            return None
        return Transfer(next(self._uid), src, dst, size, t_avail, prof)

    def commit_transfer(self, transfer: Transfer, force: bool = False) -> None:
        """Apply a planned transfer's reservation to the residual links.

        ``force=True`` permits oversubscription (recorded as a negative
        residual): the simulator uses it when enacting a plan computed on
        the lagged monitor view after the actual NIC rate changed.
        """
        for link in self._wpath(transfer.src, transfer.dst):
            link.subtract_profile(transfer.profile, allow_deficit=force)

    def release(self, transfer: Transfer) -> None:
        """Undo a reservation (used by replication's lead-reduction, §5.3)."""
        for link in self._wpath(transfer.src, transfer.dst):
            link.add_profile(transfer.profile)

    def compact(self, t_now: float) -> None:
        """Forget timeline history before ``t_now`` on every link.

        Long dynamic-cluster runs otherwise accumulate one breakpoint per
        past NIC-rate change / reservation remnant forever, degrading
        every ``bisect``-backed query.  Call only with a monotonically
        advancing simulation clock — queries at ``t < t_now`` become
        meaningless afterwards.
        """
        for tl in self.up.values():
            tl.forget_before(t_now)
        for tl in self.down.values():
            tl.forget_before(t_now)


class _OverlayLinks(Mapping):
    """Read-only mapping view: ``delta`` entries shadow ``base``.

    Iteration order is deterministic: base order (minus removed hosts)
    followed by overlay-added hosts in insertion order.
    """

    __slots__ = ("_base", "_delta", "_removed")

    def __init__(self, base: Mapping[str, Timeline],
                 delta: Dict[str, Timeline], removed: set):
        self._base = base
        self._delta = delta
        self._removed = removed

    def __getitem__(self, host: str) -> Timeline:
        if host in self._removed:
            raise KeyError(host)
        tl = self._delta.get(host)
        if tl is not None:
            return tl
        return self._base[host]

    def __iter__(self) -> Iterator[str]:
        for h in self._base:
            if h not in self._removed:
                yield h
        for h in self._delta:
            if h not in self._base and h not in self._removed:
                yield h

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, host: object) -> bool:
        if host in self._removed:
            return False
        return host in self._delta or host in self._base


class NetworkOverlay(NetworkState):
    """Copy-on-write delta view over a base :class:`NetworkState`.

    Reads fall through to the base; the first write to a link copies just
    that one ``Timeline`` into the delta (O(changes) total, however large
    the fleet).  ``copy()`` materializes a flat ``NetworkState``.  The view
    is only valid while the base is unmutated.
    """

    def __init__(self, base: NetworkState):
        self._base = base
        self._removed: set = set()
        self._up_delta: Dict[str, Timeline] = {}
        self._down_delta: Dict[str, Timeline] = {}
        self.up = _OverlayLinks(base.up, self._up_delta, self._removed)
        self.down = _OverlayLinks(base.down, self._down_delta, self._removed)
        self._uid = base._uid  # shared: uids stay unique across views

    def changed_hosts(self) -> List[str]:
        """Hosts whose links this overlay has written (repair diagnostics)."""
        seen = dict.fromkeys(itertools.chain(self._up_delta, self._down_delta,
                                             self._removed))
        return list(seen)

    def _wup(self, host: str) -> Timeline:
        tl = self._up_delta.get(host)
        if tl is None:
            tl = self.up[host].copy()   # KeyError if removed/unknown
            self._up_delta[host] = tl
        return tl

    def _wdown(self, host: str) -> Timeline:
        tl = self._down_delta.get(host)
        if tl is None:
            tl = self.down[host].copy()
            self._down_delta[host] = tl
        return tl

    def add_host(self, host: str, bw: float) -> None:
        self._removed.discard(host)
        self._up_delta[host] = Timeline(bw)
        self._down_delta[host] = Timeline(bw)

    def remove_host(self, host: str) -> None:
        self._up_delta.pop(host, None)
        self._down_delta.pop(host, None)
        self._removed.add(host)

    def compact(self, t_now: float) -> None:
        # never reach through to the base: compacting a shared timeline
        # would mutate state other overlays / the owner still read
        for tl in self._up_delta.values():
            tl.forget_before(t_now)
        for tl in self._down_delta.values():
            tl.forget_before(t_now)


# --------------------------------------------------------------------------- #
# lossy links (DESIGN.md §12)
# --------------------------------------------------------------------------- #
class LossSchedule:
    """Per-host, per-direction byte-loss rates over time.

    Kept *separate* from :class:`NetworkState` on purpose: loss does not
    change link capacity (dropped bytes still consumed bandwidth), it
    changes how many of the delivered bytes are *useful*.  The schedule
    holds two families of piecewise-constant rate functions per
    ``(host, direction)`` link — ``drop`` (bytes vanish) and ``corrupt``
    (bytes arrive as garbage) — reusing :class:`Timeline` for the
    bisect-indexed segment storage.  Timelines are created lazily on the
    first nonzero rate, so an inactive schedule is two empty dicts and
    every query short-circuits to exactly ``0.0`` (the zero-loss golden
    guarantee).

    Loss composes along a path like independent Bernoulli thinning: a byte
    survives ``src``'s uplink with probability ``1 - drop_up`` and
    ``dst``'s downlink with ``1 - drop_down``; corruption applies to the
    bytes that survived the drop stage.  All queries are deterministic
    expected-value ("fluid") quantities — the simulator never flips a coin
    per packet, which keeps seeded runs reproducible and costs zero draws
    from the simulation RNG.
    """

    def __init__(self) -> None:
        self._drop: Dict[Tuple[str, str], Timeline] = {}
        self._corrupt: Dict[Tuple[str, str], Timeline] = {}

    @property
    def active(self) -> bool:
        return bool(self._drop or self._corrupt)

    # -- mutation -------------------------------------------------------- #
    @staticmethod
    def _set(table: Dict[Tuple[str, str], Timeline], host: str, t: float,
             rate: float, until: Optional[float], direction: str) -> None:
        if not (0.0 <= rate < 1.0):
            raise ValueError(f"loss rate must be in [0, 1): {rate}")
        dirs = ("up", "down") if direction == "both" else (direction,)
        for d in dirs:
            tl = table.get((host, d))
            if tl is None:
                if rate == 0.0 and until is None:
                    continue    # clearing a link that was never lossy
                tl = table[(host, d)] = Timeline(0.0)
            # a window is two future-rate edicts; a later set_rate_from at
            # t' < until truncates the window — the newest event wins
            tl.set_rate_from(t, rate)
            if until is not None:
                tl.set_rate_from(until, 0.0)

    def set_drop(self, host: str, t: float, rate: float, *,
                 until: Optional[float] = None,
                 direction: str = "both") -> None:
        self._set(self._drop, host, t, rate, until, direction)

    def set_corrupt(self, host: str, t: float, rate: float, *,
                    until: Optional[float] = None,
                    direction: str = "both") -> None:
        self._set(self._corrupt, host, t, rate, until, direction)

    def remove_host(self, host: str) -> None:
        for table in (self._drop, self._corrupt):
            table.pop((host, "up"), None)
            table.pop((host, "down"), None)

    def compact(self, t_now: float) -> None:
        for table in (self._drop, self._corrupt):
            for tl in table.values():
                tl.forget_before(t_now)

    # -- queries --------------------------------------------------------- #
    def _links(self, table: Dict[Tuple[str, str], Timeline], src: str,
               dst: str) -> List[Timeline]:
        links = []
        tl = table.get((src, "up"))
        if tl is not None:
            links.append(tl)
        tl = table.get((dst, "down"))
        if tl is not None:
            links.append(tl)
        return links

    @staticmethod
    def _path_rate(rates: Sequence[float]) -> float:
        """Combine per-link loss rates: 1 - prod(1 - r)."""
        keep = 1.0
        for r in rates:
            keep *= 1.0 - r
        return 1.0 - keep

    def instant_loss(self, src: str, dst: str, t: float) -> Tuple[float, float]:
        """``(drop, corrupt)`` path loss rates at instant ``t``."""
        if src == dst or not self.active:
            return 0.0, 0.0
        drop = self._path_rate(
            [tl.rate_at(t) for tl in self._links(self._drop, src, dst)])
        corrupt = self._path_rate(
            [tl.rate_at(t) for tl in self._links(self._corrupt, src, dst)])
        return drop, corrupt

    def transfer_loss(self, src: str, dst: str,
                      profile: Profile) -> Tuple[float, float]:
        """Byte-weighted ``(dropped, corrupted)`` fractions of a transfer.

        Walks the transfer's reserved profile chunks against the loss
        timelines (merged-breakpoint walk, like the path-bottleneck walk).
        A byte is *dropped* with the path drop rate; *corrupted* only if it
        survived the drop stage.  Returns exact ``(0.0, 0.0)`` when no
        loss timeline touches the path.
        """
        if src == dst or not self.active:
            return 0.0, 0.0
        dls = self._links(self._drop, src, dst)
        cls_ = self._links(self._corrupt, src, dst)
        if not dls and not cls_:
            return 0.0, 0.0
        size = profile.size
        if size <= 0.0:
            return 0.0, 0.0
        tls = dls + cls_
        nd = len(dls)
        dropped = corrupted = 0.0
        for t0, t1, r in profile.chunks:
            if t1 <= t0 or r <= 0.0:
                continue
            iters = [tl.segments(t0) for tl in tls]
            cur = [next(it) for it in iters]
            t = t0
            while t < t1:
                t_next = min(min(c[1] for c in cur), t1)
                p_drop = self._path_rate([c[2] for c in cur[:nd]])
                p_corr = self._path_rate([c[2] for c in cur[nd:]])
                chunk = r * (t_next - t)
                dropped += chunk * p_drop
                corrupted += chunk * (1.0 - p_drop) * p_corr
                if t_next >= t1:
                    break
                t = t_next
                for k, c in enumerate(cur):
                    if c[1] <= t_next:
                        cur[k] = next(iters[k])
        return dropped / size, corrupted / size


# --------------------------------------------------------------------------- #
# unit helpers
# --------------------------------------------------------------------------- #
def gbps(x: float) -> float:
    """Gigabits/s -> bytes/s."""
    return x * 1e9 / 8.0


def mb(x: float) -> float:
    """Megabytes -> bytes."""
    return x * 1e6


def seconds(x: float) -> float:
    return x
