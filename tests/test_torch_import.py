"""The port imports torch and never jax.

The check runs in a subprocess because ``tests/conftest.py`` imports jax
into every test process.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
before = set(sys.modules)
import {mods}
new = set(sys.modules) - before
leaked = sorted(m for m in new if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""


@pytest.mark.parametrize("mods", [
    "embeddinghub_tpu_torch",
    "embeddinghub_tpu_torch.ops.distance, embeddinghub_tpu_torch.ops.fused_topk, "
    "embeddinghub_tpu_torch.ops.topk, embeddinghub_tpu_torch.ops._build",
    "embeddinghub_tpu_torch.index.base, embeddinghub_tpu_torch.index.flat",
    "embeddinghub_tpu_torch.store.errors, embeddinghub_tpu_torch.store.keymap, "
    "embeddinghub_tpu_torch.store.version, embeddinghub_tpu_torch.store.space, "
    "embeddinghub_tpu_torch.store.hub",
    "embeddinghub_tpu_torch.service.server",
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
