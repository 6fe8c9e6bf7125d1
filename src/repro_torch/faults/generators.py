"""The structured fault-scenario family (see :mod:`repro_torch.faults.base`).

A copy of ``repro.faults.generators`` whose grids run on an ops object
(``xp``: NumPy or torch on a device) in place of ``np``/``jnp``.  Four
generators, each advertising analytic statistics that
``tests/test_torch_faults.py`` holds equal to ``repro``'s at fixed seeds:

  * :class:`CorrelatedTorOutages` -- whole power-domain (ToR/pod) outage
    events OR'd with independent per-node background faults; analytic
    marginal fault ratio and *positive intra-domain correlation* (every
    node of a domain goes down together when the PDU does).
  * :class:`MaintenanceWindows` -- a deterministic rolling schedule (one
    domain per period, seeded phase/rotation); the marginal is exact, at
    most one domain is ever down at a time.
  * :class:`BurstStorms` -- storms with truncated-geometric (memoryless)
    inter-arrival gaps; each storm knocks out a Bernoulli subset of nodes
    whose per-node recovery is truncated-geometric, so the downed count
    decays exponentially after the hit.
  * :class:`FlappingStragglers` -- a seeded Bernoulli subset of nodes
    square-wave flaps between healthy and straggling; the same windows
    are exposed as a per-step timing schedule for
    ``ClusterManager.flag_stragglers`` / ``ElasticRunner``.

All masks derive from uint32 threefry draws plus integer/boolean ops, so
``masks()`` (NumPy) and ``torch_masks()`` (torch) are bit-identical --
pinned by the SHA-256 digests of ``tests/test_prng_digests.py``, which
``tests/test_torch_faults.py`` copies.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .base import (NUMPY_OPS, NumpyDraw, StructuredScenario, bernoulli,
                   trunc_geometric, trunc_geometric_mean, uniform_int,
                   wrap_occupancy)

# named sub-streams (fold_in data); unique per draw site within a generator
_S_DOM_START, _S_DOM_DUR, _S_DOM_ACTIVE = 1, 2, 3
_S_NODE_START, _S_NODE_DUR, _S_NODE_ACTIVE = 4, 5, 6
_S_PHASE, _S_ROTATION = 1, 2
_S_GAP, _S_HIT, _S_DECAY = 1, 2, 3
_S_MEMBER, _S_FLAP_PHASE = 1, 2


class CorrelatedTorOutages(StructuredScenario):
    """Power-domain outages: every node behind a failed ToR/PDU drops at
    once, on top of independent per-node background faults.

    Each of the ``events_per_domain`` slots per domain is active with
    probability ``event_p``, starts uniformly on the circular tick grid
    and lasts uniform ``[dur_min_ticks, dur_max_ticks]`` ticks; node
    background events use the same machinery per node.  Circular time
    keeps the marginal exactly uniform, so the advertised statistics are
    closed-form (:meth:`expected_fault_ratio`,
    :meth:`expected_intra_domain_correlation`).
    """

    label = "tor-outages"

    def __init__(self, samples: int = 336, tick_h: float = 1.0,
                 seed: int = 0, *, domain_nodes: int = 8,
                 events_per_domain: int = 4, event_p: float = 0.5,
                 dur_min_ticks: int = 2, dur_max_ticks: int = 12,
                 node_events: int = 2, node_event_p: float = 0.25,
                 node_dur_min_ticks: int = 1, node_dur_max_ticks: int = 6):
        super().__init__(samples, tick_h, seed)
        if domain_nodes < 1:
            raise ValueError("domain_nodes must be >= 1")
        for lo, hi in ((dur_min_ticks, dur_max_ticks),
                       (node_dur_min_ticks, node_dur_max_ticks)):
            if not 1 <= lo <= hi <= self.samples:
                raise ValueError("durations must satisfy 1 <= min <= max "
                                 "<= samples (wraparound occupancy)")
        self.domain_nodes = int(domain_nodes)
        self.events_per_domain = int(events_per_domain)
        self.event_p = float(event_p)
        self.dur_min_ticks = int(dur_min_ticks)
        self.dur_max_ticks = int(dur_max_ticks)
        self.node_events = int(node_events)
        self.node_event_p = float(node_event_p)
        self.node_dur_min_ticks = int(node_dur_min_ticks)
        self.node_dur_max_ticks = int(node_dur_max_ticks)

    def _events(self, xp, draw, streams, lanes, count, p, dmin, dmax):
        s_start, s_dur, s_active = streams
        starts = uniform_int(draw.bits(s_start, (lanes, count)),
                             self.samples, xp)
        span = dmax - dmin + 1
        durs = dmin + uniform_int(draw.bits(s_dur, (lanes, count)), span, xp)
        active = bernoulli(draw.bits(s_active, (lanes, count)), p, xp)
        return wrap_occupancy(xp, self.samples, starts, durs, active)

    def _grid(self, num_nodes, xp, draw):
        node_down = self._events(
            xp, draw, (_S_NODE_START, _S_NODE_DUR, _S_NODE_ACTIVE),
            num_nodes, self.node_events, self.node_event_p,
            self.node_dur_min_ticks, self.node_dur_max_ticks)
        n_domains = num_nodes // self.domain_nodes
        if n_domains == 0:
            return node_down
        dom_down = self._events(
            xp, draw, (_S_DOM_START, _S_DOM_DUR, _S_DOM_ACTIVE),
            n_domains, self.events_per_domain, self.event_p,
            self.dur_min_ticks, self.dur_max_ticks)
        modeled = n_domains * self.domain_nodes
        expand = xp.repeat(dom_down, self.domain_nodes, 1)
        tail = xp.zeros((self.samples, num_nodes - modeled))
        return node_down | xp.concatenate([expand, tail], 1)

    # ------------------------------------------------- analytic statistics

    def domain_down_p(self) -> float:
        """P(a given domain is down at a given tick)."""
        per_slot = self.event_p \
            * ((self.dur_min_ticks + self.dur_max_ticks) / 2.0) \
            / self.samples
        return 1.0 - (1.0 - per_slot) ** self.events_per_domain

    def node_background_p(self) -> float:
        """P(a given node's background process is down at a given tick)."""
        per_slot = self.node_event_p \
            * ((self.node_dur_min_ticks + self.node_dur_max_ticks) / 2.0) \
            / self.samples
        return 1.0 - (1.0 - per_slot) ** self.node_events

    def expected_fault_ratio(self, num_nodes: int) -> float:
        """Marginal fault ratio over all node-ticks (tail nodes beyond the
        last full domain only see the background process)."""
        pd, pn = self.domain_down_p(), self.node_background_p()
        modeled = (num_nodes // self.domain_nodes) * self.domain_nodes
        p_in = 1.0 - (1.0 - pd) * (1.0 - pn)
        return (modeled * p_in + (num_nodes - modeled) * pn) / num_nodes

    def expected_intra_domain_correlation(self) -> float:
        """Pearson correlation of the fault indicators of two distinct
        nodes in one domain (they share the domain outage indicator)."""
        pd, pn = self.domain_down_p(), self.node_background_p()
        px = 1.0 - (1.0 - pd) * (1.0 - pn)
        exy = pd + (1.0 - pd) * pn * pn
        var = px * (1.0 - px)
        return (exy - px * px) / var if var > 0 else 0.0


class MaintenanceWindows(StructuredScenario):
    """Rolling scheduled maintenance: every ``period_ticks`` one whole
    domain is drained for ``window_ticks``, cycling through the domains
    from a seeded rotation offset with a seeded phase.  Deterministic
    given the seed: the marginal is *exact* (:meth:`expected_fault_ratio`)
    and at most one domain is ever down at a time."""

    label = "maintenance"

    def __init__(self, samples: int = 336, tick_h: float = 1.0,
                 seed: int = 0, *, domain_nodes: int = 8,
                 period_ticks: int = 24, window_ticks: int = 4):
        super().__init__(samples, tick_h, seed)
        if not 1 <= window_ticks <= period_ticks:
            raise ValueError("need 1 <= window_ticks <= period_ticks")
        if domain_nodes < 1:
            raise ValueError("domain_nodes must be >= 1")
        self.domain_nodes = int(domain_nodes)
        self.period_ticks = int(period_ticks)
        self.window_ticks = int(window_ticks)

    def _schedule(self, n_domains, xp, draw):
        phase = uniform_int(draw.bits(_S_PHASE, (1,)),
                            self.period_ticks, xp)[0]
        rot = uniform_int(draw.bits(_S_ROTATION, (1,)), n_domains, xp)[0]
        t = xp.arange(self.samples)
        rel = t - phase                     # negative before the phase
        in_window = (rel >= 0) & (xp.mod(rel, self.period_ticks)
                                  < self.window_ticks)
        period_idx = xp.where(rel >= 0, xp.floordiv(rel, self.period_ticks),
                              0)
        dom_t = xp.mod(rot + period_idx, n_domains)
        return in_window, dom_t

    def _grid(self, num_nodes, xp, draw):
        n_domains = num_nodes // self.domain_nodes
        if n_domains == 0:
            return xp.zeros((self.samples, num_nodes))
        in_window, dom_t = self._schedule(n_domains, xp, draw)
        doms = xp.floordiv(xp.arange(num_nodes), self.domain_nodes)
        return in_window[:, None] & (doms[None, :] == dom_t[:, None])

    def expected_fault_ratio(self, num_nodes: int) -> float:
        """Exact node-tick fault fraction (the schedule is deterministic
        given the seed): in-window ticks each drain one full domain."""
        n_domains = num_nodes // self.domain_nodes
        if n_domains == 0:
            return 0.0
        in_window, _ = self._schedule(n_domains, NUMPY_OPS,
                                      NumpyDraw(self.seed))
        return int(in_window.sum()) * self.domain_nodes \
            / (self.samples * num_nodes)


class BurstStorms(StructuredScenario):
    """Failure storms with exponential decay.

    Storm arrivals are separated by truncated-geometric gaps
    (``1 + TruncGeom(gap_continue_p)``, capped at ``gap_cap_ticks``) --
    the memoryless inter-arrival distribution the stats suite verifies.
    Each storm hits every node independently with probability ``hit_p``;
    a hit node stays down for ``1 + TruncGeom(decay_continue_p)`` ticks
    (capped at ``decay_cap_ticks``), so the number of still-down nodes
    decays geometrically -- exponentially in time -- after the burst.
    Storms whose cumulative gap passes the horizon simply never land.
    """

    label = "burst-storms"

    def __init__(self, samples: int = 336, tick_h: float = 1.0,
                 seed: int = 0, *, max_storms: int = 24,
                 gap_continue_p: float = 0.9, gap_cap_ticks: int = 64,
                 hit_p: float = 0.25, decay_continue_p: float = 0.6,
                 decay_cap_ticks: int = 24):
        super().__init__(samples, tick_h, seed)
        if max_storms < 1:
            raise ValueError("max_storms must be >= 1")
        if gap_cap_ticks < 2 or decay_cap_ticks < 2:
            raise ValueError("caps must be >= 2 ticks")
        self.max_storms = int(max_storms)
        self.gap_continue_p = float(gap_continue_p)
        self.gap_cap_ticks = int(gap_cap_ticks)
        self.hit_p = float(hit_p)
        self.decay_continue_p = float(decay_continue_p)
        self.decay_cap_ticks = int(decay_cap_ticks)

    def _gaps(self, xp, draw):
        bits = draw.bits(_S_GAP, (self.max_storms, self.gap_cap_ticks - 1))
        return trunc_geometric(bits, self.gap_continue_p, xp)

    def _hits_durations(self, num_nodes, xp, draw):
        hit = bernoulli(draw.bits(_S_HIT, (self.max_storms, num_nodes)),
                        self.hit_p, xp)
        bits = draw.bits(_S_DECAY, (self.max_storms, num_nodes,
                                    self.decay_cap_ticks - 1))
        return hit, trunc_geometric(bits, self.decay_continue_p, xp)

    def _grid(self, num_nodes, xp, draw):
        gaps = self._gaps(xp, draw)
        starts = xp.cumsum(gaps, 0) - 1
        hit, durs = self._hits_durations(num_nodes, xp, draw)
        t = xp.arange(self.samples)[:, None, None]
        s = starts[None, :, None]
        cov = hit[None] & (t >= s) & (t < s + durs[None])
        return xp.any(cov, 1)

    # helpers the stats/benchmark suites use (NumPy, same draws as _grid)
    def storm_gaps(self) -> np.ndarray:
        return np.asarray(self._gaps(NUMPY_OPS, NumpyDraw(self.seed)))

    def storm_starts(self) -> np.ndarray:
        return np.cumsum(self.storm_gaps().astype(np.int64)) - 1

    def hit_durations(self, num_nodes: int):
        """``(hit, durations)`` per (storm, node), NumPy."""
        hit, durs = self._hits_durations(num_nodes, NUMPY_OPS,
                                         NumpyDraw(self.seed))
        return np.asarray(hit), np.asarray(durs)

    def expected_gap_ticks(self) -> float:
        return trunc_geometric_mean(self.gap_continue_p,
                                    self.gap_cap_ticks - 1)

    def expected_duration_ticks(self) -> float:
        return trunc_geometric_mean(self.decay_continue_p,
                                    self.decay_cap_ticks - 1)


class FlappingStragglers(StructuredScenario):
    """A seeded subset of nodes flaps: ``down_ticks`` straggling out of
    every ``up_ticks + down_ticks`` cycle, with a seeded per-node phase.

    The flapping windows are emitted both as fault masks (the scenario
    contract) and as per-step node timings
    (:meth:`straggler_schedule`) whose slow steps exceed the
    ``ClusterManager.flag_stragglers`` median threshold, so the same
    windows drive ``ElasticRunner``'s straggler path end to end.
    """

    label = "flappers"

    def __init__(self, samples: int = 336, tick_h: float = 1.0,
                 seed: int = 0, *, flap_p: float = 0.1, up_ticks: int = 5,
                 down_ticks: int = 1, slow_factor: float = 4.0):
        super().__init__(samples, tick_h, seed)
        if up_ticks < 1 or down_ticks < 1:
            raise ValueError("up_ticks and down_ticks must be >= 1")
        if slow_factor <= 1.0:
            raise ValueError("slow_factor must exceed 1.0")
        self.flap_p = float(flap_p)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.slow_factor = float(slow_factor)

    @property
    def cycle_ticks(self) -> int:
        return self.up_ticks + self.down_ticks

    def _grid(self, num_nodes, xp, draw):
        member = bernoulli(draw.bits(_S_MEMBER, (num_nodes,)),
                           self.flap_p, xp)
        phase = uniform_int(draw.bits(_S_FLAP_PHASE, (num_nodes,)),
                            self.cycle_ticks, xp)
        t = xp.arange(self.samples)[:, None]
        down = xp.mod(t + phase[None, :], self.cycle_ticks) < self.down_ticks
        return member[None, :] & down

    def flappers(self, num_nodes: int) -> List[int]:
        member = bernoulli(NumpyDraw(self.seed).bits(_S_MEMBER,
                                                     (num_nodes,)),
                           self.flap_p, NUMPY_OPS)
        return np.nonzero(member)[0].tolist()

    def expected_fault_ratio(self, num_nodes: int) -> float:
        return self.flap_p * self.down_ticks / self.cycle_ticks

    def straggler_schedule(self, num_nodes: int, steps: int,
                           base_s: float = 1.0) -> Dict[int, Dict[int, float]]:
        """Per-step node step-times for ``ElasticRunner.run``: step ``s``
        reports ``base_s * slow_factor`` for every node flapping at tick
        ``s % samples`` and ``base_s`` elsewhere -- above the 1.5x-median
        ``flag_stragglers`` threshold whenever under half the fleet flaps.
        """
        masks = self.masks(num_nodes)
        sched: Dict[int, Dict[int, float]] = {}
        for step in range(int(steps)):
            row = masks[step % self.samples]
            sched[step] = {i: base_s * (self.slow_factor if row[i] else 1.0)
                           for i in range(num_nodes)}
        return sched


__all__ = ["CorrelatedTorOutages", "MaintenanceWindows", "BurstStorms",
           "FlappingStragglers"]
