"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose every layer kind the port runs are listed;
the others join with the slices that port their modules.
"""

from .base import ModelConfig
from .mamba2_780m import CONFIG as MAMBA2
from .starcoder2_3b import CONFIG as STARCODER2

ARCHS = {c.name: c for c in [STARCODER2, MAMBA2]}

# short aliases for --arch
ALIASES = {
    "starcoder2": STARCODER2.name,
    "mamba2": MAMBA2.name,
}


def get_arch(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)} (aliases {sorted(ALIASES)})")
    return ARCHS[name]


__all__ = ["ARCHS", "ALIASES", "ModelConfig", "get_arch"]
