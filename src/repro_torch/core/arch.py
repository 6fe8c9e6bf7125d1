"""One registry contract per HBD architecture: the :class:`ArchSpec`.

A copy of ``repro.core.arch`` whose device-kernel field is ``torch_kernel``
(``jax_kernel`` in the JAX package), with the same contract.  The engines
named below that the port does not have yet (DCN, cost, churn) come with
their slices; the fields they read are kept.

Before this module, adding a rival network architecture meant hand-editing
four engines -- the scenario kernels (``repro_torch.sim``), the DCN placement
variants (``repro_torch.dcn``), the BOM registry (``repro_torch.core.cost_model``) and
the churn/MFU bridges.  An :class:`ArchSpec` bundles everything those
engines need:

  * ``factory``            -- builds the :class:`~repro_torch.core.hbd_models.\
HBDModel`; the model's overridden ``evaluate`` is the scalar reference and
    its overridden ``_batch_eval`` the batched NumPy kernel (both are
    *required*: the bit-exactness gate needs the pair);
  * ``bom``                -- a Table-8-style :class:`~repro_torch.core.\
cost_model.ArchBOM`, or ``unpriceable`` -- an explicit one-line reason why
    no BOM can exist (idealized baselines).  Exactly one must be set so an
    architecture can never be silently absent from the §6.5 cost axis;
  * ``torch_kernel``       -- optional ``(model, tp_sizes) -> fn`` builder
    for the device backend (builtins use the type-keyed kernels in
    ``repro_torch.sim.torch_backend``; external models supply their own);
  * ``placement_variant``  -- the ``repro_torch.dcn`` traffic/placement model the
    architecture maps to (``None`` for topology-free idealizations);
  * ``default_sweep``      -- whether the architecture joins
    ``DEFAULT_ARCHITECTURES`` (replaces the old hard-coded ``dgx-h100``
    exclusion in ``repro_torch.sim.scenario``).

``MODEL_FACTORIES`` and ``PRICED_BOMS`` are *live* read-only mapping views
over the registry, re-exported as ``repro_torch.sim.MODEL_REGISTRY`` and
``repro_torch.core.cost_model.BOM_REGISTRY`` so every existing consumer sees
newly registered architectures without further wiring.  Rival-architecture
modules live in :mod:`repro_torch.archs` (one self-contained module + one
``register()`` call each) and are loaded lazily on first registry access.

:func:`register` enforces the contract for every registration (the JAX
package's ``tools/check_registry.py`` checks its own registry);
``tests/test_torch_sweep.py`` holds this registry's names, order and
specs to ``repro.core.arch``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .cost_model import (ArchBOM, DGX_H100, INFINITEHBD_K2, INFINITEHBD_K3,
                         NVL36, NVL72, NVL576, TPUV4)
from .hbd_models import (BigSwitch, HBDModel, InfiniteHBDModel, NVLModel,
                         SiPRingModel, TPUv4Model)

ModelFactory = Callable[[int, int], HBDModel]
#: ``(model, tp_sizes) -> (masks -> (faulty, placed))`` torch kernel builder,
#: same contract as the builders in ``repro_torch.sim.torch_backend``:
#: ``(rows, W)`` bool masks in, two ``(rows, T)`` int32 tensors out.
KernelBuilder = Callable[[HBDModel, Sequence[int]], Callable]

#: The contract's required fields, quoted by registration errors so the
#: instructions cannot drift from the dataclass itself.
CONTRACT = (
    ("factory", "(num_nodes, gpus_per_node) -> HBDModel subclass that "
                "overrides evaluate() [scalar reference] AND _batch_eval() "
                "[batched NumPy kernel, bit-exact vs the scalar path]"),
    ("bom | unpriceable", "a Table-8-style ArchBOM whose .name matches, OR "
                          "a one-line reason the architecture cannot be "
                          "priced (exactly one of the two)"),
    ("torch_kernel", "optional (model, tp_sizes) -> torch kernel builder "
                     "for the device backend, batched over snapshot rows "
                     "(builtin model types already have type-keyed "
                     "kernels)"),
    ("placement_variant", "optional repro_torch.dcn placement variant name for "
                          "the DCN traffic axis (None = no topology model)"),
)

_PROBE_NODES = 64


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Everything the sim/dcn/cost/churn engines need for one architecture."""

    name: str
    factory: ModelFactory
    bom: Optional[ArchBOM] = None
    unpriceable: Optional[str] = None
    torch_kernel: Optional[KernelBuilder] = None
    placement_variant: Optional[str] = None
    default_sweep: bool = True
    paper: str = ""

    @property
    def priced(self) -> bool:
        return self.bom is not None


_REGISTRY: Dict[str, ArchSpec] = {}
_LOADED = False


def _ensure_loaded() -> None:
    """Import :mod:`repro_torch.archs` once so rival registrations are visible."""
    global _LOADED
    if not _LOADED:
        _LOADED = True
        from .. import archs  # noqa: F401  (modules register on import)


def registration_help() -> str:
    """The contract's required fields, as one error-message block."""
    lines = [f"  {field}: {what}" for field, what in CONTRACT]
    return ("register one with repro_torch.core.arch.register(ArchSpec(...)) -- "
            "one self-contained module per architecture under src/repro_torch/"
            "archs/ (see railx.py there for a complete example); required "
            "fields:\n" + "\n".join(lines))


def register(spec: ArchSpec, *, replace: bool = False) -> ArchSpec:
    """Validate and add one architecture to the registry.

    Validation probes the factory on a tiny cluster: the model must carry
    the spec's name and override both evaluation paths (the scalar
    reference and the batched kernel the bit-exactness gate compares).
    """
    if not spec.name or not isinstance(spec.name, str):
        raise ValueError(f"ArchSpec.name must be a non-empty str, "
                         f"got {spec.name!r}")
    if spec.name in _REGISTRY and not replace:
        raise ValueError(f"architecture {spec.name!r} already registered "
                         "(pass replace=True to override)")
    if (spec.bom is None) == (spec.unpriceable is None):
        raise ValueError(
            f"architecture {spec.name!r} must set exactly one of bom= "
            "(Table-8-style ArchBOM) and unpriceable= (reason string); "
            + registration_help())
    if spec.bom is not None and spec.bom.name != spec.name:
        raise ValueError(f"architecture {spec.name!r} has a BOM named "
                         f"{spec.bom.name!r}; the names must match")
    model = spec.factory(_PROBE_NODES, 4)
    if not isinstance(model, HBDModel):
        raise TypeError(f"factory for {spec.name!r} returned "
                        f"{type(model).__name__}, not an HBDModel")
    if model.name != spec.name:
        raise ValueError(f"factory for {spec.name!r} built a model named "
                         f"{model.name!r}; the names must match")
    if type(model).evaluate is HBDModel.evaluate:
        raise TypeError(f"architecture {spec.name!r} is missing the scalar "
                        "reference: its model must override evaluate(); "
                        + registration_help())
    if type(model)._batch_eval is HBDModel._batch_eval:
        raise TypeError(f"architecture {spec.name!r} is missing a batched "
                        "kernel: its model must override _batch_eval() "
                        "(the base class falls back to looping the scalar "
                        "path, which the engines refuse); "
                        + registration_help())
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    """The spec of one registered architecture, or a KeyError that lists
    the registered names and the contract's required fields."""
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; registered: "
            f"{sorted(_REGISTRY)}; " + registration_help()) from None


def find(name: str) -> Optional[ArchSpec]:
    _ensure_loaded()
    return _REGISTRY.get(name)


def names() -> Tuple[str, ...]:
    """All registered architecture names, in registration order."""
    _ensure_loaded()
    return tuple(_REGISTRY)


def specs() -> List[ArchSpec]:
    """All registered specs, in registration order."""
    _ensure_loaded()
    return list(_REGISTRY.values())


def default_architectures() -> Tuple[str, ...]:
    """The default sweep suite: every spec with ``default_sweep=True``,
    in registration order (the §6.1 paper order for the builtins)."""
    _ensure_loaded()
    return tuple(n for n, s in _REGISTRY.items() if s.default_sweep)


def make_model(name: str, num_nodes: int, gpus_per_node: int = 4) -> HBDModel:
    return get(name).factory(num_nodes, gpus_per_node)


def bom_for(name: str) -> ArchBOM:
    """BOM of a priced architecture; KeyError (listing the priced names)
    for unpriceable ones -- same contract as the historical
    ``repro_torch.core.cost_model.bom_for``."""
    spec = find(name)
    if spec is None or spec.bom is None:
        raise KeyError(f"no BOM for architecture {name!r}; priced: "
                       f"{sorted(PRICED_BOMS)}")
    return spec.bom


class _LiveView(Mapping):
    """Read-only name-keyed mapping view over the registry.

    Iteration order is registration order; entries whose extracted value is
    ``None`` are omitted (so the BOM view only shows priced architectures).
    """

    def __init__(self, extract: Callable[[ArchSpec], object]):
        self._extract = extract

    def _items(self) -> Dict[str, object]:
        _ensure_loaded()
        return {n: v for n, s in _REGISTRY.items()
                if (v := self._extract(s)) is not None}

    def __getitem__(self, key: str):
        return self._items()[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._items())

    def __len__(self) -> int:
        return len(self._items())

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}({self._items()!r})"


#: Live ``name -> factory`` view (re-exported as ``repro_torch.sim.MODEL_REGISTRY``).
MODEL_FACTORIES: Mapping = _LiveView(lambda s: s.factory)

#: Live ``name -> ArchBOM`` view over the priced architectures (re-exported
#: as ``repro_torch.core.cost_model.BOM_REGISTRY``).
PRICED_BOMS: Mapping = _LiveView(lambda s: s.bom)


# ------------------------------------------------- builtin registrations
# The §6.1 evaluation suite, in paper order (matching the historical
# ``repro_torch.sim.scenario.MODEL_REGISTRY`` literal).  Builtins leave
# ``torch_kernel=None``: the device backend keys its builders on the builtin
# model *types* (``repro_torch.sim.torch_backend._KERNELS``) and only consults the
# spec for external types.

def _dgx_model(n: int, g: int) -> NVLModel:
    """DGX-class 8-GPU NVLink islands, no optical spares (paper §6.3's
    DGX baseline for the MFU comparison)."""
    m = NVLModel(n, g, hbd_gpus=8, spare_fraction=0.0)
    m.name = "dgx-h100"
    return m


_PAPER = "InfiniteHBD (arXiv 2502.03885)"

register(ArchSpec(
    name="big-switch", factory=lambda n, g: BigSwitch(n, g),
    unpriceable="idealized single-switch upper bound; no physical BOM "
                "exists at datacenter scale",
    placement_variant=None, paper=_PAPER + " §6.1 idealized baseline"))
register(ArchSpec(
    name="infinitehbd-k2", factory=lambda n, g: InfiniteHBDModel(n, g, k=2),
    bom=INFINITEHBD_K2, placement_variant="orchestrated", paper=_PAPER))
register(ArchSpec(
    name="infinitehbd-k3", factory=lambda n, g: InfiniteHBDModel(n, g, k=3),
    bom=INFINITEHBD_K3, placement_variant="orchestrated", paper=_PAPER))
register(ArchSpec(
    name="nvl-36", factory=lambda n, g: NVLModel(n, g, hbd_gpus=36),
    bom=NVL36, placement_variant="dgx-island",
    paper="NVIDIA NVL-36 (paper Table 1 baseline)"))
register(ArchSpec(
    name="nvl-72", factory=lambda n, g: NVLModel(n, g, hbd_gpus=72),
    bom=NVL72, placement_variant="dgx-island",
    paper="NVIDIA NVL-72 (paper Table 1 baseline)"))
register(ArchSpec(
    name="nvl-576",
    factory=lambda n, g: NVLModel(n, g, hbd_gpus=576, spare_fraction=0.0),
    bom=NVL576, placement_variant="dgx-island",
    paper="NVIDIA NVL-576 (paper Table 1 baseline)"))
register(ArchSpec(
    name="tpuv4", factory=lambda n, g: TPUv4Model(n, g),
    bom=TPUV4, placement_variant="dgx-island",
    paper="TPUv4 OCS (paper Table 1 baseline)"))
register(ArchSpec(
    name="sip-ring", factory=lambda n, g: SiPRingModel(n, g),
    unpriceable="research SiP static-ring proposal; the paper publishes "
                "no Table-8 BOM for it",
    placement_variant="dgx-island",
    paper="SiP-Ring (paper Table 1 baseline)"))
register(ArchSpec(
    name="dgx-h100", factory=_dgx_model, bom=DGX_H100,
    placement_variant="dgx-island", default_sweep=False,
    paper=_PAPER + " §6.3 DGX baseline (extension BOM)"))


__all__ = [
    "ArchSpec", "CONTRACT", "KernelBuilder", "MODEL_FACTORIES",
    "ModelFactory", "PRICED_BOMS", "bom_for", "default_architectures",
    "find", "get", "make_model", "names", "register", "registration_help",
    "specs",
]
