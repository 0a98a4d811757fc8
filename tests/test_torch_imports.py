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


# the scripts that run the port on the card, beside the package
SCRIPTS = ("chip_smoke.py", "e2e_turns.py", "scan_sections.py",
           "peer_order.py")


def _port_files():
    out = [os.path.join(ROOT, s) for s in SCRIPTS]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel in SCRIPTS:
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


# the observability substrate, which the walk above must reach too (the
# subprocess import and the AST scan below then cover it)
OBSERVABILITY = (
    "utils.flightrecorder", "utils.ledger", "utils.telemetry",
    "utils.profiling", "timeline", "timeline.events", "timeline.recorder",
    "timeline.invariants", "timeline.generators")


def test_the_walk_covers_the_observability_substrate():
    mods = set(_modules())
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in OBSERVABILITY:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod
        path = os.path.join("karpenter_tpu_torch", *mod.split("."))
        assert (path + ".py" in files
                or os.path.join(path, "__init__.py") in files), mod


# the external stores, fault hooks and cloud-call batching, which the walk
# above must reach too (the subprocess import and the AST scan below then
# cover them)
STORES_AND_FAULTS = (
    "utils.faults", "store.remote", "store.http", "store.__main__",
    "utils.batcher", "providers.batched_cloud",
    "operator.leaderelection", "models.v1beta1", "providers.ec2_catalog")


def test_the_walk_covers_the_stores_and_faults():
    mods = set(_modules())
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in STORES_AND_FAULTS:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod
        path = os.path.join("karpenter_tpu_torch", *mod.split("."))
        assert path + ".py" in files, mod


def test_the_walk_covers_the_cross_card_solve():
    """The column-sharded solve across cards (K7x): its modules are in the
    walk (the subprocess import and the AST scan below then cover them),
    its CUDA source and the exchange's header are in csrc, and every
    entry point `_cuda.ENTRIES` names is exported by its source."""
    from karpenter_tpu_torch.solver import _cuda
    mods = set(_modules())
    for mod in ("parallel", "parallel.mesh", "solver.ffd", "solver._cuda"):
        assert f"karpenter_tpu_torch.{mod}" in mods, mod
    csrc = os.path.join(PKG, "csrc")
    assert os.path.exists(os.path.join(csrc, "ffd_xcard.cuh"))
    assert "ffd_card_scan" in _cuda.KERNELS
    assert set(_cuda.ENTRIES.values()) == set(_cuda.KERNELS)
    for entry, src in _cuda.ENTRIES.items():
        with open(os.path.join(csrc, f"{src}.cu")) as f:
            assert f'extern "C" int {entry}(' in f.read(), entry
    assert {e for e, s in _cuda.ENTRIES.items() if s == "ffd_card_scan"} \
        == {"ffd_card_scan", "ffd_card_gang_scan", "ffd_card_delta_scan",
            "ffd_card_occupancy", "ffd_card_peer", "ffd_card_launch",
            "ffd_card_events"}


# the operator process and its entry point, the device bootstrap, the
# shadow audit and the rewind engine, which the walk above must reach too
# (the subprocess import and the AST scan below then cover them)
OPERATOR = ("__main__", "operator.operator", "utils.platform",
            "utils.profiling", "utils.knobs", "solver.audit",
            "timeline.rewind")


def test_the_walk_covers_the_operator():
    mods = set(_modules())
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in OPERATOR:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod
        path = os.path.join("karpenter_tpu_torch", *mod.split("."))
        assert path + ".py" in files, mod


# the solver service, the lock observer and the post-mortem tools, which
# the walk above must reach too (the subprocess import and the AST scan
# below then cover them)
SERVICE = ("service", "service.resilience", "service.scheduler",
           "service.backend", "service.client", "service.supervisor",
           "service.loopback", "utils.lockwatch", "tools", "tools.kt_replay",
           "tools.kt_explain")


def test_the_walk_covers_the_service():
    mods = set(_modules())
    for mod in SERVICE:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod


# the operator's tools, the port's twins of the repository's tools/,
# hack/determinism_harness.py and deploy/run_ha.py (the subprocess import
# and the AST scan below cover them)
TOOLS = ("tools.kt_ledger", "tools.kt_rewind", "tools.allocatable_diff",
         "tools.determinism", "tools.run_ha")


def test_the_walk_covers_the_tools():
    mods = set(_modules())
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in TOOLS:
        assert f"karpenter_tpu_torch.{mod}" in mods, mod
        path = os.path.join("karpenter_tpu_torch", *mod.split("."))
        assert path + ".py" in files, mod


def test_every_reference_module_has_its_counterpart():
    """A listing of both trees: every module of the JAX package has the
    module of the same path in the port."""
    ref = os.path.join(ROOT, "karpenter_tpu")
    missing = []
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ref)
                if not os.path.exists(os.path.join(PKG, rel)):
                    missing.append(rel)
    assert missing == []


def _public_names(path: str) -> set:
    """The public module-level names of the module at `path`, read from
    its source: what its top level (and the top level's if/try blocks)
    defines, and in a package's __init__.py what it imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    init = os.path.basename(path) == "__init__.py"
    out = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                out.update(n.id for t in node.targets for n in ast.walk(t)
                           if isinstance(n, ast.Name))
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                out.add(node.target.id)
            elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0]
                           for a in node.names if a.name != "*")
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                for h in getattr(node, "handlers", ()):
                    walk(h.body)
                walk(node.orelse)

    walk(tree.body)
    return {n for n in out if not n.startswith("_")}


# The reference's public names that the port leaves out on purpose, by
# module (a path under both packages), each with its reason.
JAX_ONLY_NAMES = {
    # the jitted XLA programs, their donated-buffer and coalesced-upload
    # wrappers and their retrace counters: the port's kernels replace the
    # programs (the `solve_ffd_*` wrappers the port keeps launch them),
    # and nothing there is traced
    "solver/ffd.py": {"TRACE_COUNT", "TRACE_LOG", "pack_problem",
                      "solve_ffd_batch_donated", "solve_ffd_coalesced",
                      "solve_ffd_coalesced_donated",
                      "solve_ffd_sweep_donated", "solve_ffd_sweep_topo",
                      "solve_ffd_sweep_topo_donated"},
    # the JAX solver class: the port's is TorchSolver
    "solver/solve.py": {"TPUSolver"},
    # the reference's device-resident result slots: the port's pipeline
    # keeps pinned host slots instead
    "solver/pipeline.py": {"DeviceSlots"},
    # the shard_map program: the port launches K7 (ffd.sharded_solve_ffd)
    "parallel/mesh.py": {"sharded_solve_ffd"},
    "parallel/__init__.py": {"sharded_solve_ffd"},
    # the TPU holder's process-group teardown and its attempt log: the
    # card needs no holder to terminate (dropped in the operator slice)
    "utils/platform.py": {"terminate_holder", "terminate_group",
                          "log_attempt"},
}


def _module_pairs():
    ref = os.path.join(ROOT, "karpenter_tpu")
    for d, _, files in os.walk(ref):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ref)
                if os.path.exists(os.path.join(PKG, rel)):
                    yield rel, os.path.join(d, f), os.path.join(PKG, rel)


def test_every_reference_public_name_has_its_counterpart():
    """Each module of the port defines every public module-level name of
    the reference's module of the same path, but for JAX_ONLY_NAMES."""
    missing = {}
    for rel, ref_path, port_path in _module_pairs():
        gone = (_public_names(ref_path) - _public_names(port_path)
                - JAX_ONLY_NAMES.get(rel, set()))
        if gone:
            missing[rel] = sorted(gone)
    assert missing == {}


def test_the_jax_only_names_are_absent_from_the_port():
    """Every allowed name is the reference's and is not the port's: the
    allow-list holds nothing stale."""
    pairs = {rel: (r, p) for rel, r, p in _module_pairs()}
    for rel, allowed in JAX_ONLY_NAMES.items():
        ref_path, port_path = pairs[rel]
        assert allowed <= _public_names(ref_path), rel
        assert not allowed & _public_names(port_path), rel


def test_the_repaired_names_equal_the_references():
    """The two names the port once lacked hold the reference's values."""
    from karpenter_tpu.providers import catalog as ref_catalog
    from karpenter_tpu.solver import explain as ref_explain
    from karpenter_tpu_torch.providers import catalog
    from karpenter_tpu_torch.solver import explain
    assert explain.POOL_CAUSES == ref_explain.POOL_CAUSES
    assert isinstance(explain.POOL_CAUSES, frozenset)
    types = catalog.generate_catalog()
    by_name = catalog.catalog_by_name(types)
    ref_by_name = ref_catalog.catalog_by_name(
        ref_catalog.generate_catalog())
    assert sorted(by_name) == sorted(ref_by_name)
    assert all(by_name[it.name] is it for it in types)


def test_solver_worker_maps_no_jax(tmp_path):
    """kt_solverd started with the port's backend (`SolverdSupervisor`,
    which always passes `--module karpenter_tpu_torch.service.backend`)
    on the CPU: the worker answers stats from the port's backend, and no
    jaxlib or libtpu object is mapped into its process."""
    from karpenter_tpu_torch.service import SolverServiceClient
    from karpenter_tpu_torch.service import supervisor as sup_mod
    try:
        sup_mod.build_binary()
    except RuntimeError as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    env = dict(os.environ, KARPENTER_TPU_FORCE_CPU="1", OMP_NUM_THREADS="1")
    env.pop("KARPENTER_TPU_FAULTS", None)
    sock = str(tmp_path / "kt.sock")
    sup = sup_mod.SolverdSupervisor(sock, env=env,
                                    stderr_path=str(tmp_path / "err"))
    sup.start(timeout=120)
    client = SolverServiceClient(sock, timeout=120)
    try:
        worker = client.stats()["worker"]
        pid = sup.worker_pid
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    finally:
        client.close()
        sup.stop()
    assert worker["pid"] == pid and worker["device"] == "cpu"
    assert "libtorch" in maps
    assert "jaxlib" not in maps and "libtpu" not in maps
    assert sup.last_exit == 0  # SIGTERM ends the worker cleanly


def test_operator_process_loads_no_jax(tmp_path):
    """`python -m karpenter_tpu_torch` on the CPU in a process of its
    own, stopped by SIGTERM once it serves: every module it imported
    (`-X importtime`) is the port's, torch's or another library's, with
    neither jax nor the JAX package."""
    import signal
    env = dict(os.environ, PYTHONPATH=ROOT, KARPENTER_TPU_PLATFORM="cpu",
               KARPENTER_TPU_METRICS_PORT="0", KARPENTER_TPU_HEALTH_PORT="0")
    # the import log (torch's included) outgrows a pipe's buffer: a file
    log = tmp_path / "stderr"
    with open(log, "w") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "karpenter_tpu_torch"], stdout=subprocess.PIPE, stderr=errf,
            text=True, cwd=str(tmp_path), env=env)
        try:
            banner = proc.stdout.readline()
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.communicate(timeout=60)
    err = log.read_text()
    assert "device=cpu" in banner and "health=:" in banner, err[-2000:]
    assert proc.returncode == 0, err[-2000:]
    loaded = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
              if line.startswith("import time:") and "|" in line]
    assert "karpenter_tpu_torch.operator.operator" in loaded
    assert "karpenter_tpu_torch.utils.platform" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_store_daemon_process_loads_no_jax():
    """`python -m karpenter_tpu_torch.store <socket>` in a process of its
    own: every module it imports (`-X importtime`) is the port's or the
    standard library's, with neither jax nor the JAX package, and not
    even torch (the daemon holds pickled bytes and needs no device)."""
    import signal
    import tempfile
    sock = tempfile.mktemp(prefix="kt_store_imports_", suffix=".sock")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "karpenter_tpu_torch.store", sock],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd="/",
        env=env)
    try:
        ready = proc.stdout.readline()
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    assert ready.strip().endswith(sock)
    assert proc.returncode == 0, err[-2000:]
    loaded = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
              if line.startswith("import time:") and "|" in line]
    assert "karpenter_tpu_torch.store.remote" in loaded
    assert "karpenter_tpu_torch.utils.faults" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert [m for m in loaded if m.split(".")[0] == "torch"] == []


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

