"""The port stands alone: no JAX and no ``repro`` at run time, and its
entry points run on the card unless told otherwise."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
# the host modules of repro.core that the port copies
CORE = ("ocstrx", "topology", "mfu_sim", "fault_sim", "orchestrator", "placement",
        "control_plane")
# the DCN engine, the churn replays, the cost and serving-SLO engines and
# the structured fault generators
ENGINES = ("dcn.engine", "dcn.incremental", "dcn.kernel", "dcn.tables", "dcn.torch_backend",
           "dcn.traffic", "churn.mfu_bridge", "churn.monte_carlo", "churn.replay",
           "churn.timeline", "churn.traffic", "kernels.prefix_scan.host",
           "cost", "cost.engine", "cost.tables", "cost.bridge", "sim.tables",
           "slo", "slo.arrivals", "slo.capacity", "slo.engine", "slo.torch_backend",
           "slo.tables", "faults", "faults.base", "faults.generators", "faults.torch_mirror")
# the parallel slice: rules, specs, meshes, collectives, pipeline, the
# production meshes and the elastic runtime
PARALLEL = ("parallel", "parallel.sharding", "parallel.specs", "parallel.mesh",
            "parallel.collectives", "parallel.pipeline", "launch.mesh", "train.elastic")
# "repro" as a whole name: repro_torch does not match
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|,|$)", re.M)


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert len(MODULES) >= 15 and "repro_torch.models.moe" in MODULES
    assert {"repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_2b",
            *(f"repro_torch.core.{m}" for m in CORE),
            *(f"repro_torch.{m}" for m in ENGINES),
            *(f"repro_torch.{m}" for m in PARALLEL)} <= set(MODULES)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_repro(path):
    assert not FORBIDDEN.findall((ROOT / path).read_text())


def test_scan_pattern_tells_repro_from_repro_torch():
    assert FORBIDDEN.search("from repro.models import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    import repro\n")
    assert not FORBIDDEN.search("from repro_torch.models import x")
    assert not FORBIDDEN.search("import jaxtyping_like_name")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_arch("starcoder2").reduced()
    with pytest.raises((RuntimeError, AssertionError)):
        init_params(cfg, torch.Generator().manual_seed(0))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        ServeEngine(cfg, model)
    with pytest.raises(KeyError, match="starcoder2"):
        get_arch("no-such-arch")

    from repro_torch.core import make_orchestrated_mesh, plan_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train.elastic import ElasticConfig, ElasticRunner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_orchestrated_mesh(plan_mesh(8, 1, tp_size=2, dp_size=2), world_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticRunner(ElasticConfig(num_nodes=64), "unused", lambda *a: None)
