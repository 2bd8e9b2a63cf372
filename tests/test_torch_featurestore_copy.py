"""The port's feature store is the JAX package's, copied.

Each module of ``embeddinghub_tpu_torch/featurestore/`` must equal its
counterpart under ``embeddinghub_tpu/featurestore/`` once
``embeddinghub_tpu.`` is renamed ``embeddinghub_tpu_torch.`` and the
docstrings are stripped from both syntax trees (comments are not in the
tree).  The modules with port-specific code may differ only in the
definitions named in ``_DIFFERS``: a top-level name, or ``Class.method``.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "embeddinghub_tpu" / "featurestore"
PORT = REPO / "embeddinghub_tpu_torch" / "featurestore"

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
]

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
    have = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
    assert have == sorted(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_is_the_reference_renamed(module):
    ref = (JAX / module).read_text().replace(
        "embeddinghub_tpu.", "embeddinghub_tpu_torch.")
    want, got = _tree(ref), _tree((PORT / module).read_text())
    allowed = _DIFFERS.get(module, set())
    if not allowed:
        assert ast.dump(got) == ast.dump(want)
        return
    want_defs, got_defs = _definitions(want.body), _definitions(got.body)
    assert list(got_defs) == list(want_defs)
    differ = {n for n in want_defs if got_defs[n] != want_defs[n]}
    assert differ <= allowed, sorted(differ - allowed)


def test_the_check_sees_a_change(tmp_path):
    """A one-token change of a copied module fails the comparison."""
    ref = (JAX / "serving.py").read_text().replace(
        "embeddinghub_tpu.", "embeddinghub_tpu_torch.")
    assert "k: int" in ref
    assert ast.dump(_tree(ref.replace("k: int", "k: float", 1))) != ast.dump(_tree(ref))
    with_doc = ref.replace('"""', '"""Changed. ', 1)
    assert ast.dump(_tree(with_doc)) == ast.dump(_tree(ref))
