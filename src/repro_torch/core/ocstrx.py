"""OCSTrx: Silicon-Photonics optical-circuit-switching transceiver model.

This models the paper's §4.1/§5.1 device at the level the rest of the system
needs: three mutually-exclusive light paths (two external + one cross-lane
loopback), microsecond-scale reconfiguration, insertion loss / BER / power
envelopes taken from the paper's hardware evaluation.  The model is used by

  * ``core.topology``       -- which path is active determines live edges,
  * ``core.control_plane``  -- reconfiguration latency bounds failover time,
  * ``core.fault_sim``      -- transceiver failures look like regular
                               transceiver failures (no new failure modes),
  * ``core.cost_model``     -- unit cost / power of the OCSTrx BOM line.

A copy of ``repro.core.ocstrx``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class Path(enum.Enum):
    """The three switchable light paths of one OCSTrx (Fig. 3a)."""

    EXT1 = "ext1"          # external path 1 (primary neighbor)
    EXT2 = "ext2"          # external path 2 (backup neighbor)
    LOOPBACK = "loopback"  # cross-lane intra-node loopback
    DARK = "dark"          # no path driven (administratively down)


# Hardware constants from the paper (§5.1).
RECONFIG_LATENCY_US = (60.0, 80.0)       # measured hardware switch latency
INSERTION_LOSS_DB = (2.5, 4.0)           # range at room temperature
INSERTION_LOSS_MEAN_DB = 3.3             # average @ 25C
CORE_POWER_W = 3.2                       # OCS core module, 3 paths active
PERIPHERAL_POWER_W = 8.5                 # 8x112G serdes peripheral circuitry
TOTAL_POWER_BUDGET_W = 12.0              # QSFP-DD 800G envelope
LANE_RATE_GBPS = 112.0                   # per-lane PAM4
LANES = 8                                # 8 pairs of TX/RX serdes
BANDWIDTH_GBPS = 800.0                   # nominal module bandwidth
UNIT_COST_USD = 600.0                    # Table 8 BOM line


def reconfig_latency_us(rng=None,
                        latency_range: Optional[Tuple[float, float]] = None) -> float:
    """Sample a hardware reconfiguration latency (uniform over measured range).

    ``latency_range`` overrides the paper's 60-80us measurement -- churn
    sweeps vary it through ``repro.core.control_plane.ControlPlaneConfig``.
    """
    lo, hi = latency_range if latency_range is not None else RECONFIG_LATENCY_US
    if rng is None:
        return 0.5 * (lo + hi)
    return float(rng.uniform(lo, hi))


def insertion_loss_db(temperature_c: float = 25.0, rng=None) -> float:
    """Sample insertion loss.  Loss grows mildly with ambient temperature
    (Fig. 11 shows the distribution shifting right by ~0.3dB from -5C to 75C)."""
    shift = 0.004 * (temperature_c - 25.0)
    if rng is None:
        return INSERTION_LOSS_MEAN_DB + shift
    lo, hi = INSERTION_LOSS_DB
    base = rng.normal(INSERTION_LOSS_MEAN_DB, (hi - lo) / 6.0)
    return float(min(max(base + shift, lo), hi + 0.5))


def bit_error_rate(oma_dbm: float, temperature_c: float = 25.0) -> float:
    """BER model distilled from Fig. 12: zero in most cases; at high ambient
    temperature and very low optical modulation amplitude occasional errors."""
    if temperature_c <= 25.0:
        return 0.0
    if oma_dbm >= -4.0:
        return 0.0
    # exponential onset below the OMA floor, scaled by temperature margin
    temp_factor = (temperature_c - 25.0) / 50.0
    return min(1e-9 * math.exp(-(oma_dbm + 4.0)) * temp_factor, 1e-6)


@dataclasses.dataclass
class OCSTrx:
    """State machine for one transceiver.

    A transceiver allocates its full bandwidth to exactly one active path
    (time-division reallocation): activating one external path disables the
    other, which is precisely what lets InfiniteHBD avoid splitting GPU
    bandwidth across redundant links.
    """

    trx_id: str
    active: Path = Path.LOOPBACK
    failed: bool = False
    temperature_c: float = 25.0
    reconfig_count: int = 0
    busy_until_us: float = 0.0  # sim-time until which the switch is settling

    def switch(self, path: Path, now_us: float = 0.0, rng=None,
               latency_range: Optional[Tuple[float, float]] = None) -> float:
        """Request a path switch.  Returns the sim-time at which the new path
        is live.  Raises if the module has failed."""
        if self.failed:
            raise RuntimeError(f"OCSTrx {self.trx_id} has failed")
        if path is self.active:
            return max(now_us, self.busy_until_us)
        start = max(now_us, self.busy_until_us)
        done = start + reconfig_latency_us(rng, latency_range)
        self.active = path
        self.reconfig_count += 1
        self.busy_until_us = done
        return done

    def fail(self) -> None:
        self.failed = True
        self.active = Path.DARK

    @property
    def power_w(self) -> float:
        if self.failed or self.active is Path.DARK:
            return 0.0
        return CORE_POWER_W + PERIPHERAL_POWER_W

    def link_budget_ok(self, tx_power_dbm: float = 1.0,
                       rx_sensitivity_dbm: float = -6.0) -> bool:
        """Optical link budget check with the measured insertion loss."""
        loss = insertion_loss_db(self.temperature_c)
        return tx_power_dbm - loss >= rx_sensitivity_dbm


@dataclasses.dataclass
class OCSTrxBundle:
    """A bundle of OCSTrx serving one GPU pair (Fig. 4).

    One node with R GPUs carries R bundles; each bundle pairs two GPUs (one on
    the upper-half SerDes, one on the lower half) and fans out ``width``
    modules (e.g. 8x800G for a 6.4Tbps GPU).
    """

    bundle_id: str
    width: int = 8
    modules: Optional[list] = None

    def __post_init__(self):
        if self.modules is None:
            self.modules = [OCSTrx(f"{self.bundle_id}.{i}") for i in range(self.width)]

    def switch_all(self, path: Path, now_us: float = 0.0, rng=None,
                   latency_range: Optional[Tuple[float, float]] = None) -> float:
        """Switch every module in the bundle; returns the last settle time.
        Modules switch in parallel so the bundle latency equals the max."""
        return max(m.switch(path, now_us, rng, latency_range)
                   for m in self.modules if not m.failed) \
            if any(not m.failed for m in self.modules) else now_us

    @property
    def healthy(self) -> bool:
        return all(not m.failed for m in self.modules)

    @property
    def bandwidth_gbps(self) -> float:
        return sum(BANDWIDTH_GBPS for m in self.modules if not m.failed)

    @property
    def power_w(self) -> float:
        return sum(m.power_w for m in self.modules)
