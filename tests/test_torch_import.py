"""The port imports torch and never jax, and nothing of the JAX package
(``embeddinghub_tpu``), not even its jax-free modules.

The import check runs in a subprocess because ``tests/conftest.py`` imports
jax and the JAX package into every test process.  A second check reads the
import statements of every source file of the port and of
``chip_smoke.py``, which import inside functions too; a third reads their
string constants, where a module name reaches ``python -m`` or an import
by name (``importlib``) without an import statement.
"""

import ast
import os
import re
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
    "embeddinghub_tpu_torch.utils.tracing",
    "embeddinghub_tpu_torch.featurestore",
    "embeddinghub_tpu_torch.featurestore.fferr, embeddinghub_tpu_torch.featurestore.logging, "
    "embeddinghub_tpu_torch.featurestore.feature_flag, "
    "embeddinghub_tpu_torch.featurestore.variant_names, "
    "embeddinghub_tpu_torch.featurestore.resources, embeddinghub_tpu_torch.featurestore.ffsync, "
    "embeddinghub_tpu_torch.featurestore.scheduling, "
    "embeddinghub_tpu_torch.featurestore.notifications, "
    "embeddinghub_tpu_torch.featurestore.status_display, "
    "embeddinghub_tpu_torch.featurestore.metadata, embeddinghub_tpu_torch.featurestore.search",
    "embeddinghub_tpu_torch.featurestore.providers, "
    "embeddinghub_tpu_torch.featurestore.providers.base, "
    "embeddinghub_tpu_torch.featurestore.providers.memory_online, "
    "embeddinghub_tpu_torch.featurestore.providers.sqlite_offline, "
    "embeddinghub_tpu_torch.featurestore.providers.sqlite_online, "
    "embeddinghub_tpu_torch.featurestore.providers.pandas_offline, "
    "embeddinghub_tpu_torch.featurestore.providers.redis_online, "
    "embeddinghub_tpu_torch.featurestore.providers.engine_vector",
    "embeddinghub_tpu_torch.featurestore.transform_engine, "
    "embeddinghub_tpu_torch.featurestore.transform_worker, "
    "embeddinghub_tpu_torch.featurestore.coordinator, embeddinghub_tpu_torch.featurestore.serving, "
    "embeddinghub_tpu_torch.featurestore.registry, embeddinghub_tpu_torch.featurestore.class_api, "
    "embeddinghub_tpu_torch.featurestore.executor_credentials",
    "embeddinghub_tpu_torch.featurestore.proto, "
    "embeddinghub_tpu_torch.featurestore.proto.serving_pb2, "
    "embeddinghub_tpu_torch.featurestore.proto.serving_pb2_grpc, "
    "embeddinghub_tpu_torch.featurestore.proto.metadata_pb2, "
    "embeddinghub_tpu_torch.featurestore.proto.metadata_pb2_grpc, "
    "embeddinghub_tpu_torch.featurestore.proto.ff_metadata_pb2, "
    "embeddinghub_tpu_torch.featurestore.proto.ff_metadata_grpc, "
    "embeddinghub_tpu_torch.featurestore.proto.ff_scheduling_pb2, "
    "embeddinghub_tpu_torch.featurestore.proto.ff_scheduling_grpc",
    "embeddinghub_tpu_torch.featurestore.metrics, embeddinghub_tpu_torch.featurestore.interceptors, "
    "embeddinghub_tpu_torch.featurestore.health, embeddinghub_tpu_torch.featurestore.serving_grpc, "
    "embeddinghub_tpu_torch.featurestore.remote_client, "
    "embeddinghub_tpu_torch.featurestore.metadata_wire, embeddinghub_tpu_torch.featurestore.api_wire, "
    "embeddinghub_tpu_torch.featurestore.tasks_wire, "
    "embeddinghub_tpu_torch.featurestore.metadata_grpc, embeddinghub_tpu_torch.featurestore.dashboard",
    "embeddinghub_tpu_torch.main",
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


# a dotted name under the JAX package, as ``-m`` or ``importlib`` take it:
# its first component after ``embeddinghub_tpu.`` is a subpackage or module
# of the JAX package (a wire name such as the metadata proto's package
# ``embeddinghub_tpu.metadata.proto`` names none)
_JAX_NAMES = sorted(
    p.stem for p in (Path(REPO) / "embeddinghub_tpu").iterdir()
    if (p.is_dir() and (p / "__init__.py").exists())
    or (p.suffix == ".py" and p.stem != "__init__"))
_MODULE_NAME = re.compile(r"(?<![\w.])embeddinghub_tpu\.(?:%s)(?:\.[A-Za-z_]\w*)*\b"
                          % "|".join(_JAX_NAMES))


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def _module_names_in_strings(path):
    """``(line, name)`` of every dotted name under the JAX package that a
    string constant of the file holds, docstrings aside."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstrings(tree)
    return [(node.lineno, name) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            for name in _MODULE_NAME.findall(node.value)]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_string_names_a_jax_package_module(path):
    """No string constant names a module of the JAX package (a ``-m``
    target of a subprocess, a name for ``importlib``)."""
    bad = _module_names_in_strings(path)
    assert not bad, f"{path.name} names {bad}"


def test_string_check_sees_a_module_target(tmp_path):
    """The check flags the JAX package's own worker target, and not the
    port's; it flags every module of the JAX package and no wire name."""
    ref = Path(REPO) / "embeddinghub_tpu" / "featurestore" / "transform_engine.py"
    assert [n for _, n in _module_names_in_strings(ref)] == [
        "embeddinghub_tpu.featurestore.transform_worker"]
    port = Path(REPO) / "embeddinghub_tpu_torch" / "featurestore" / "transform_engine.py"
    assert "embeddinghub_tpu_torch.featurestore.transform_worker" in port.read_text()
    assert _module_names_in_strings(port) == []
    probe = tmp_path / "probe.py"
    probe.write_text(
        'A = "embeddinghub_tpu.main"\n'
        'B = "-m embeddinghub_tpu.service.server"\n'
        'C = "embeddinghub_tpu.metadata.proto.Metadata"\n'
        'D = "embeddinghub_tpu"\n'
        'E = "embeddinghub_tpu.featurestore"\n')
    assert [n for _, n in _module_names_in_strings(probe)] == [
        "embeddinghub_tpu.main", "embeddinghub_tpu.service.server",
        "embeddinghub_tpu.featurestore"]
    wire = Path(REPO) / "embeddinghub_tpu_torch" / "featurestore" / "proto" / "metadata_pb2_grpc.py"
    assert "embeddinghub_tpu.metadata.proto.Metadata" in wire.read_text()
    assert _module_names_in_strings(wire) == []
