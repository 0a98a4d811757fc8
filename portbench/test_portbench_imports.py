"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: `karpenter_tpu_torch` is the program, allowed;
`karpenter_tpu` is not), the reference imports nothing of the program,
and nothing reads the JAX package's benchmark files."""

import ast
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = {"jax", "jaxlib", "flax", "karpenter_tpu"}
NOT_READ = {"chip_smoke", "bench", "benchmarks"}


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere():
    found = {p: sorted(set(_imports(p)) & (BANNED | NOT_READ))
             for p in _sources()}
    assert not {p: v for p, v in found.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for p in _sources():
        if p.startswith(ref + os.sep):
            assert "karpenter_tpu_torch" not in set(_imports(p)), p
            assert "portbench" not in set(_imports(p)), p


def test_the_check_is_by_whole_names():
    from portbench import harness
    import sys
    sys.modules.setdefault("karpenter_tpu_torch_probe", object())
    try:
        assert "karpenter_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("karpenter_tpu_torch_probe", None)
