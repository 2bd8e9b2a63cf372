"""The port imports torch and never jax, and nothing of the JAX package
(``embeddinghub_tpu``), not even its jax-free modules.

The import check runs in a subprocess because ``tests/conftest.py`` imports
jax and the JAX package into every test process.  A second check reads the
import statements of every source file of the port and of
``chip_smoke.py``, which import inside functions too.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
before = set(sys.modules)
import {mods}
new = set(sys.modules) - before
leaked = sorted(m for m in new if m in ("jax", "embeddinghub_tpu")
                or m.startswith(("jax.", "jaxlib", "embeddinghub_tpu.")))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "embeddinghub_tpu")


@pytest.mark.parametrize("mods", [
    "embeddinghub_tpu_torch",
    "embeddinghub_tpu_torch.ops.distance, embeddinghub_tpu_torch.ops.fused_topk, "
    "embeddinghub_tpu_torch.ops.topk, embeddinghub_tpu_torch.ops._build",
    "embeddinghub_tpu_torch.index.base, embeddinghub_tpu_torch.index.flat",
    "embeddinghub_tpu_torch.index.hnsw, embeddinghub_tpu_torch.ops.beam, "
    "embeddinghub_tpu_torch.ops.nn_descent, embeddinghub_tpu_torch.ops.wave_insert",
    "embeddinghub_tpu_torch.store.errors, embeddinghub_tpu_torch.store.keymap, "
    "embeddinghub_tpu_torch.store.version, embeddinghub_tpu_torch.store.space, "
    "embeddinghub_tpu_torch.store.hub",
    "embeddinghub_tpu_torch.service.server",
    "embeddinghub_tpu_torch.service.spawn",
    "embeddinghub_tpu_torch.store.persistence",
    "embeddinghub_tpu_torch.sdk",
    "embeddinghub_tpu_torch.sdk.client",
    "embeddinghub_tpu_torch.sdk.offline",
    "embeddinghub_tpu_torch.sdk.repl",
    "embeddinghub_tpu_torch.service.batcher, embeddinghub_tpu_torch.service.interceptors, "
    "embeddinghub_tpu_torch.service.proto",
    "embeddinghub_tpu_torch.utils.config, embeddinghub_tpu_torch.utils.channels, "
    "embeddinghub_tpu_torch.utils.device",
    "embeddinghub_tpu_torch.parallel",
    "embeddinghub_tpu_torch.parallel.mesh, embeddinghub_tpu_torch.parallel.sharded_flat, "
    "embeddinghub_tpu_torch.parallel.sharded_hnsw, embeddinghub_tpu_torch.parallel.dryrun",
])
def test_port_imports_no_jax(mods):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mods=mods)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_import_skips_server():
    """``import embeddinghub_tpu_torch`` needs only torch and numpy: it does
    not import the server, and with it grpc."""
    code = ("import sys, embeddinghub_tpu_torch, embeddinghub_tpu_torch.store.hub;"
            "sys.exit('embeddinghub_tpu_torch.service.server' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _sources():
    port = Path(REPO) / "embeddinghub_tpu_torch"
    return sorted(port.rglob("*.py")) + [Path(REPO) / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_the_jax_package(path):
    """Every ``import`` and ``from ... import`` of the file, at any depth
    (functions included): none names jax or the JAX package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"
