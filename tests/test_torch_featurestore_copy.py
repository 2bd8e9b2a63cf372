"""The port's feature store is the JAX package's, copied.

Each module of ``embeddinghub_tpu_torch/featurestore/`` must equal its
counterpart under ``embeddinghub_tpu/featurestore/`` once its module paths
are renamed (``embeddinghub_tpu.<a subpackage or module of the JAX
package>`` becomes ``embeddinghub_tpu_torch.<...>``) and the docstrings
are stripped from both syntax trees (comments are not in the tree).  Wire
names that merely start with ``embeddinghub_tpu.``, such as the metadata
proto's package ``embeddinghub_tpu.metadata.proto``, and the serialized
descriptors stay as they are.  The modules with port-specific code may
differ only in the definitions named in ``_DIFFERS``: a top-level name, or
``Class.method``.  The proto sources and the dashboard's page are
byte-equal copies.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "embeddinghub_tpu" / "featurestore"
PORT = REPO / "embeddinghub_tpu_torch" / "featurestore"

# the JAX package's subpackages and modules: the names a module path takes
# after ``embeddinghub_tpu.``
_JAX_NAMES = sorted(
    p.stem for p in (REPO / "embeddinghub_tpu").iterdir()
    if (p.is_dir() and (p / "__init__.py").exists())
    or (p.suffix == ".py" and p.stem != "__init__"))
_MODULE_PATH = re.compile(r"\bembeddinghub_tpu\.(?=(?:%s)\b)" % "|".join(_JAX_NAMES))


def renamed(text: str) -> str:
    """``text`` with the JAX package's module paths renamed to the port's."""
    return _MODULE_PATH.sub("embeddinghub_tpu_torch.", text)

MODULES = [
    "fferr.py", "logging.py", "feature_flag.py", "variant_names.py",
    "resources.py", "ffsync.py", "scheduling.py", "notifications.py",
    "status_display.py", "metadata.py", "search.py",
    "providers/base.py", "providers/memory_online.py",
    "providers/sqlite_offline.py", "providers/sqlite_online.py",
    "providers/pandas_offline.py", "providers/redis_online.py",
    "providers/__init__.py", "providers/engine_vector.py",
    "transform_engine.py", "transform_worker.py", "coordinator.py",
    "serving.py", "registry.py", "class_api.py", "executor_credentials.py",
    "__init__.py",
    # the wire: the protos, the gRPC services, the remote clients, the dashboard
    "proto/__init__.py", "proto/serving_pb2.py", "proto/serving_pb2_grpc.py",
    "proto/metadata_pb2.py", "proto/metadata_pb2_grpc.py",
    "proto/ff_metadata_pb2.py", "proto/ff_metadata_grpc.py",
    "proto/ff_scheduling_pb2.py", "proto/ff_scheduling_grpc.py",
    "metrics.py", "interceptors.py", "health.py", "serving_grpc.py",
    "remote_client.py", "metadata_wire.py", "api_wire.py", "tasks_wire.py",
    "metadata_grpc.py", "dashboard.py",
]

# copied byte for byte
BYTE_EQUAL = [
    "proto/serving.proto", "proto/metadata.proto", "proto/ff_metadata.proto",
    "proto/ff_scheduling.proto", "dashboard_ui.html",
]

# the generated message modules: every message, enum and service of theirs
# keeps its full name on the wire
_PB2 = ["serving_pb2", "metadata_pb2", "ff_metadata_pb2", "ff_scheduling_pb2"]

# where the port is not a copy: the device of the in-process engine store
# (and the registrar passing it), and the worker's environment
_DIFFERS = {
    "providers/engine_vector.py": {"EngineVectorStore.__init__"},
    "registry.py": {"Registrar.register_engine_vector_store"},
    "transform_engine.py": {"SubprocessEngine.submit"},
}


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                node.body = node.body[1:] or [ast.Pass()]
    return tree


def _tree(text):
    return _strip_docstrings(ast.parse(text))


def _definitions(body, prefix=""):
    """``{name: dump}`` of a body's statements; a class's methods are
    entries of their own (``Class.method``), the class's other statements
    stay in its entry."""
    out = {}
    for i, node in enumerate(body):
        name = getattr(node, "name", None)
        if name is None:
            out[f"{prefix}<stmt {i}>"] = ast.dump(node)
            continue
        if isinstance(node, ast.ClassDef):
            methods = [n for n in node.body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            out.update(_definitions(methods, f"{prefix}{name}."))
            rest = [n for n in node.body if n not in methods]
            node = ast.ClassDef(name=node.name, bases=node.bases,
                                keywords=node.keywords, body=rest,
                                decorator_list=node.decorator_list)
        out[prefix + name] = ast.dump(node)
    return out


def test_the_slice_is_whole():
    """The port's feature store holds exactly the modules of this list."""
    have = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)
    assert have == sorted(MODULES + BYTE_EQUAL)


@pytest.mark.parametrize("module", MODULES)
def test_module_is_the_reference_renamed(module):
    ref = renamed((JAX / module).read_text())
    want, got = _tree(ref), _tree((PORT / module).read_text())
    allowed = _DIFFERS.get(module, set())
    if not allowed:
        assert ast.dump(got) == ast.dump(want)
        return
    want_defs, got_defs = _definitions(want.body), _definitions(got.body)
    assert list(got_defs) == list(want_defs)
    differ = {n for n in want_defs if got_defs[n] != want_defs[n]}
    assert differ <= allowed, sorted(differ - allowed)


@pytest.mark.parametrize("name", BYTE_EQUAL)
def test_file_is_a_byte_copy(name):
    assert (PORT / name).read_bytes() == (JAX / name).read_bytes()


def _wire_names(module):
    """Every full name a generated module puts on the wire: its file's
    package, messages (nested ones too), enums and services with their
    methods."""
    fd = module.DESCRIPTOR
    names = [fd.name, fd.package]

    def walk(msg):
        names.append(msg.full_name)
        names.extend(e.full_name for e in msg.enum_types)
        for nested in msg.nested_types:
            walk(nested)

    for msg in fd.message_types_by_name.values():
        walk(msg)
    names.extend(e.full_name for e in fd.enum_types_by_name.values())
    for svc in fd.services_by_name.values():
        names.append(svc.full_name)
        names.extend(m.full_name for m in svc.methods)
    return names


@pytest.mark.parametrize("name", _PB2)
def test_wire_names_are_the_reference_s(name):
    """Both packages' proto modules load in one process and name every
    message, enum and service alike; the compact metadata service's method
    path keeps the JAX package's name."""
    import importlib

    ref = importlib.import_module(f"embeddinghub_tpu.featurestore.proto.{name}")
    port = importlib.import_module(f"embeddinghub_tpu_torch.featurestore.proto.{name}")
    assert _wire_names(port) == _wire_names(ref)
    assert len(_wire_names(port)) > 2
    if name == "metadata_pb2":
        from embeddinghub_tpu.featurestore.proto import metadata_pb2_grpc as ref_grpc
        from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2_grpc as port_grpc

        assert port_grpc._SERVICE == ref_grpc._SERVICE == (
            "embeddinghub_tpu.metadata.proto.Metadata")
        assert port.DESCRIPTOR.package == "embeddinghub_tpu.metadata.proto"


def test_the_rename_keeps_wire_names():
    """The rename rewrites module paths and leaves the wire names alone."""
    assert renamed("from embeddinghub_tpu.featurestore.proto import x") == (
        "from embeddinghub_tpu_torch.featurestore.proto import x")
    assert renamed("import embeddinghub_tpu.utils.channels") == (
        "import embeddinghub_tpu_torch.utils.channels")
    assert renamed('"embeddinghub_tpu.metadata.proto.Metadata"') == (
        '"embeddinghub_tpu.metadata.proto.Metadata"')
    assert renamed('namespace="embeddinghub_tpu"') == 'namespace="embeddinghub_tpu"'
    assert renamed("embeddinghub_tpu_torch.featurestore") == "embeddinghub_tpu_torch.featurestore"


def test_the_check_sees_a_change(tmp_path):
    """A one-token change of a copied module fails the comparison."""
    ref = renamed((JAX / "serving.py").read_text())
    assert "k: int" in ref
    assert ast.dump(_tree(ref.replace("k: int", "k: float", 1))) != ast.dump(_tree(ref))
    with_doc = ref.replace('"""', '"""Changed. ', 1)
    assert ast.dump(_tree(with_doc)) == ast.dump(_tree(ref))
