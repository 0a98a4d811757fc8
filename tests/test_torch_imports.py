"""The port stands alone: karpenter_tpu_torch imports torch and numpy and
never jax or the JAX package, and its solver refuses to run silently on
the CPU when it was asked for the card."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "karpenter_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                    else mod)
    return mods


def _forbidden(name: str) -> bool:
    # exact names: karpenter_tpu_torch shares the prefix
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "karpenter_tpu"
            or name.startswith("karpenter_tpu."))


# the subpackages and modules of the provisioning control loop, which the
# walk above must reach (both checks below read `_modules()`/`_port_files()`)
CONTROL_LOOP = ("native", "utils", "store", "providers", "cloudprovider",
                "cluster", "operator", "controllers")


def test_the_walk_covers_the_control_loop():
    mods = set(_modules())
    for sub in CONTROL_LOOP:
        assert f"karpenter_tpu_torch.{sub}" in mods, sub
    for mod in ("controllers.state", "controllers.provisioning",
                "controllers.lifecycle", "controllers.kubelet",
                "controllers.binder", "controllers.manager",
                "cloudprovider.provider", "providers.fake_cloud",
                "providers.instancetype", "providers.imagefamily",
                "providers.pricing", "store.backend", "operator.options",
                "utils.metrics", "utils.tracing", "utils.logging",
                "utils.cache", "utils.clock", "utils.errors",
                "solver.firstuse"):
        assert f"karpenter_tpu_torch.{mod}" in mods, mod


# the modules of the disruption control loop and the environment, which
# the walk above must reach too
DISRUPTION_LOOP = (
    "env", "utils.cron", "controllers.disruption",
    "controllers.termination", "controllers.expiration", "controllers.gc",
    "controllers.interruption", "controllers.preemption",
    "controllers.nodeclass", "controllers.tagging", "controllers.refresh",
    "providers.queue", "providers.version", "providers.subnet",
    "providers.securitygroup", "providers.instanceprofile",
    "providers.launchtemplate")


def test_the_walk_covers_the_disruption_loop():
    mods = set(_modules())
    for mod in DISRUPTION_LOOP:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from karpenter_tpu_torch.solver import TorchSolver\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd="/", env=env)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "karpenter_tpu_torch.solver.solve" in loaded
    assert "torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_solver_without_a_card_raises(monkeypatch):
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.workloads import build_input
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solver = TorchSolver()
    assert solver.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve(build_input(16))


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

