"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every architecture of ``repro.configs`` is listed, with its aliases, and
the input-shape cells of the dry run with the ones each architecture takes.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, input_specs
from .deepseek_67b import CONFIG as DEEPSEEK
from .gpt_moe import CONFIG as GPT_MOE
from .h2o_danube_1_8b import CONFIG as H2O_DANUBE
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4
from .mamba2_780m import CONFIG as MAMBA2
from .mixtral_8x7b import CONFIG as MIXTRAL
from .paligemma_3b import CONFIG as PALIGEMMA
from .qwen25_32b import CONFIG as QWEN25
from .recurrentgemma_2b import CONFIG as RECURRENTGEMMA
from .starcoder2_3b import CONFIG as STARCODER2
from .whisper_small import CONFIG as WHISPER

ARCHS = {c.name: c for c in [
    LLAMA4, MIXTRAL, MAMBA2, DEEPSEEK, QWEN25, H2O_DANUBE, STARCODER2,
    RECURRENTGEMMA, WHISPER, PALIGEMMA, GPT_MOE,
]}

# short aliases for --arch
ALIASES = {
    "llama4": LLAMA4.name,
    "mixtral": MIXTRAL.name,
    "mamba2": MAMBA2.name,
    "deepseek": DEEPSEEK.name,
    "qwen": QWEN25.name,
    "h2o-danube": H2O_DANUBE.name,
    "starcoder2": STARCODER2.name,
    "recurrentgemma": RECURRENTGEMMA.name,
    "whisper": WHISPER.name,
    "paligemma": PALIGEMMA.name,
    "gpt-moe": GPT_MOE.name,
}


def get_arch(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(ARCHS)} (aliases {sorted(ALIASES)})")
    return ARCHS[name]


def applicable_shapes(cfg: ModelConfig):
    """The assigned shape cells that apply to this architecture.

    long_500k needs sub-quadratic attention (skipped for pure full-attention
    archs); every assigned LM arch has a decode step.
    """
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return out


__all__ = ["ARCHS", "ALIASES", "SHAPES", "ModelConfig", "ShapeConfig", "applicable_shapes",
           "get_arch", "input_specs"]
