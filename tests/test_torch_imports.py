"""The port stands alone: importing ``repro_torch`` and every module
under it loads neither ``jax`` nor anything of the JAX package ``repro``,
and no source file of the port imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_modules())
    for m in ("repro_torch.core.engine", "repro_torch.core.windows",
              "repro_torch.core.slo", "repro_torch.core.admission",
              "repro_torch.distributed",
              "repro_torch.distributed.stream_sharding",
              "repro_torch.kernels.round_fuse.kernel",
              "repro_torch.kernels.round_fuse.ops",
              "repro_torch.kernels.window_agg.ops",
              "repro_torch.kernels.window_agg.kernel",
              "repro_torch.core.graph",
              "repro_torch.kernels.stream_dispatch.ref",
              "repro_torch.kernels.stream_dispatch.ops",
              "repro_torch.kernels.stream_dispatch.kernel",
              "repro_torch.workloads.dataflows",
              "repro_torch.workloads.runner",
              "repro_torch.workloads.traces",
              "repro_torch.models.config", "repro_torch.models.params",
              "repro_torch.models.layers", "repro_torch.models.attention",
              "repro_torch.models.ssm", "repro_torch.models.moe",
              "repro_torch.models.model", "repro_torch.models.convert",
              "repro_torch.configs", "repro_torch.configs.gemma3_1b",
              "repro_torch.configs.jamba_v0p1_52b",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.selective_scan.ref",
              "repro_torch.kernels.selective_scan.ops",
              "repro_torch.kernels.selective_scan.kernel",
              "repro_torch.models.xlstm", "repro_torch.configs.xlstm_1p3b",
              "repro_torch.kernels.mlstm_chunk.ref",
              "repro_torch.kernels.mlstm_chunk.ops",
              "repro_torch.kernels.mlstm_chunk.kernel",
              "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
              "repro_torch.launch", "repro_torch.launch.autoscale",
              "repro_torch.launch.chaos", "repro_torch.launch.supervise"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'jaxlib') or m.startswith(('jax.', 'jaxlib.'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"import\s+repro\s*$|from\s+repro\s+import)", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    SRC.parent / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_source_imports_jax_or_repro(path):
    assert not FORBIDDEN.search(path.read_text()), path
