"""Rival network architectures, one self-contained module each.

Copies of ``repro.archs`` whose device kernel builders are torch kernels
batched over snapshot rows (``_torch_kernel``) in place of ``_jax_kernel``.

Every module in this package defines one architecture end to end -- the
scalar reference model, the batched NumPy kernel, the torch kernel builder,
the Table-8-style BOM (or unpriceable marker) and the DCN placement hook --
and hands the bundle to :func:`repro_torch.core.arch.register` as a single
:class:`~repro_torch.core.arch.ArchSpec`.  That registration is the *only*
wiring an architecture needs: the sim/dcn/cost/churn engines all consume
the registry.

The package is imported lazily by ``repro_torch.core.arch`` on first registry
access, so modules here must not import ``repro_torch.sim`` (or anything that
imports it) at module level -- defer device-backend imports into the
kernel builder, which only runs once a torch sweep is requested.
"""

from . import rail_only, railx, ub_mesh, acos

__all__ = ["rail_only", "railx", "ub_mesh", "acos"]
