"""Device bootstrap of the operator process, the benchmarks and the tests.

The port's counterpart of `karpenter_tpu/utils/platform.py`, written for
torch and CUDA.  It keeps the reference's names and its two disciplines:

1. An explicit request beats every default: ``KARPENTER_TPU_PLATFORM``
   (``cuda`` or ``cpu``) and ``KARPENTER_TPU_FORCE_CPU`` choose the
   device; with neither the process runs on the card.  ``JAX_PLATFORMS``
   is the JAX package's knob and is never read here: a process that runs
   both packages (the tests) can pin JAX to the CPU and still ask the port
   for the card.
2. Device initialization can hang rather than raise (a card held by a
   wedged process, a driver mid-reset), so the probe runs in a THROWAWAY
   subprocess with a hard timeout, and only a successful probe lets the
   caller go on.

One difference from the reference: `initialize` never falls back to the
CPU.  A process that asked for the card and cannot have it fails at boot,
with the probe's evidence; only an explicit ``cpu`` request gives the CPU
(where the kernels' plain PyTorch versions run).  Nor does it evict the
processes that may hold the card (the reference's `terminate_holder` and
`terminate_group`, and its `log_attempt` trail, are not carried): it names
them, since the card's list holds every tenant's processes.

Mirrors the reference's boot-time EC2 connectivity probe + fail-fast
diagnostic (pkg/operator/operator.go:209-218).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from typing import Optional

DEVICES = ("cuda", "cpu")

# the probe's child program: prints `PROBE-OK cuda <count>` once CUDA
# initialized, `PROBE-NODEV` (exit 3) on a host with no card
PROBE_CODE = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    print('PROBE-NODEV', flush=True)\n"
    "    raise SystemExit(3)\n"
    "torch.cuda.init()\n"
    "print('PROBE-OK cuda', torch.cuda.device_count(), flush=True)\n"
)
_NODEV_RC = 3


def _env_platform() -> Optional[str]:
    """An explicit device request from the environment, if any:
    KARPENTER_TPU_PLATFORM, then KARPENTER_TPU_FORCE_CPU (``cpu``)."""
    val = os.environ.get("KARPENTER_TPU_PLATFORM")
    if val:
        return val
    from karpenter_tpu_torch.utils.knobs import env_bool
    if env_bool("KARPENTER_TPU_FORCE_CPU"):
        return "cpu"
    return None


def _check(want: str) -> str:
    if want not in DEVICES:
        raise ValueError(
            f"platform {want!r}: the port runs on 'cuda' (the card) or "
            "'cpu' (the kernels' plain versions)")
    return want


def repo_root() -> str:
    """The checkout root (parent of the karpenter_tpu_torch package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _parent_cmdline(ppid: str):
    """Cmdline of a process's parent, or None if the parent is gone."""
    try:
        with open(f"/proc/{ppid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return None


def scan_processes(match, orphaned_from: Optional[str] = None) -> list:
    """Best-effort list of (pid, cmdline) for processes whose cmdline
    satisfies ``match`` (excluding this process).  Never raises.

    ``orphaned_from`` (a descriptive owner label) keeps only processes
    that are truly ORPHANED: parent gone, or reparented to init (ppid
    1).  A process with any other live parent is owned by someone and
    spared."""
    found = []
    try:
        out = subprocess.run(
            ["ps", "-eo", "pid=,ppid=,args="], capture_output=True,
            text=True, timeout=5).stdout
        me = os.getpid()
        for line in out.splitlines():
            parts = line.strip().split(None, 2)
            if len(parts) != 3:
                continue
            pid_s, ppid_s, args = parts
            if not match(args) or int(pid_s) == me:
                continue
            if orphaned_from is not None and ppid_s != "1" \
                    and _parent_cmdline(ppid_s) is not None:
                continue  # live non-init parent: owned by someone
            found.append((int(pid_s), args))
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        pass
    return found


def _card_processes() -> list:
    """(pid, process name) of every compute process on the cards, as
    `nvidia-smi --query-compute-apps` lists them; empty without
    nvidia-smi.  Never raises."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    found = []
    try:
        out = subprocess.run(
            [smi, "--query-compute-apps=pid,process_name",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout
        me = os.getpid()
        for line in out.splitlines():
            pid_s, _, name = line.partition(",")
            try:
                pid = int(pid_s.strip())
            except ValueError:
                continue
            if pid != me:
                found.append((pid, name.strip()))
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        pass
    return found


def _other_device_holders() -> list:
    """Processes likely holding the card: kt_solverd daemons that aren't
    us, and every other compute process the card lists."""
    seen = {}
    for pid, args in (scan_processes(lambda args: "kt_solverd" in args)
                      + _card_processes()):
        seen.setdefault(pid, args)
    return sorted(seen.items())


def enable_compile_cache(device: str = "cuda") -> float:
    """Build every CUDA kernel of `karpenter_tpu_torch/csrc` into
    `_build/` (`solver/_cuda.py`: one nvcc per source, all at once; a
    library whose sources did not change is loaded as it is), so the
    compiler runs at boot and never inside the first solve — the
    reference's persistent XLA compile cache plays this part there.  A
    no-op on the CPU and under KARPENTER_TPU_NO_COMPILE_CACHE=1 (the
    first solve then builds).  Returns the seconds spent building; raises
    with nvcc's output when a kernel does not build."""
    from karpenter_tpu_torch.utils.knobs import env_bool
    if device != "cuda" or env_bool("KARPENTER_TPU_NO_COMPILE_CACHE"):
        return 0.0
    from karpenter_tpu_torch.solver import _cuda
    return _cuda.build()


def configure(platform: Optional[str] = None) -> str:
    """The device this process runs on, for `Environment(device=...)`.

    Resolution order: explicit arg > KARPENTER_TPU_PLATFORM >
    KARPENTER_TPU_FORCE_CPU > ``"cuda"`` (JAX_PLATFORMS is not read).
    On ``cuda`` the kernels are built here (`enable_compile_cache`).
    Returns ``"cuda"`` or ``"cpu"``; any other request raises
    ValueError."""
    want = _check(platform or _env_platform() or "cuda")
    enable_compile_cache(want)
    return want


def listening_ports() -> Optional[list]:
    """TCP ports in LISTEN state, for probe-failure evidence (what else
    this host serves while the card will not initialize).  None = no
    /proc/net."""
    ports = set()
    seen_any = False
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        seen_any = True
        for line in lines:
            parts = line.split()
            if len(parts) > 3 and parts[3] == "0A":  # LISTEN
                try:
                    ports.add(int(parts[1].split(":")[1], 16))
                except (IndexError, ValueError):
                    continue
    return sorted(ports) if seen_any else None


def scrub_cpu_overrides(env: dict) -> dict:
    """Strip CPU-forcing leftovers from a child env so the child resolves
    the accelerator: stale KARPENTER_TPU_FORCE_CPU /
    KARPENTER_TPU_PLATFORM=cpu / JAX_PLATFORMS=cpu from earlier tooling
    would otherwise make a probe (or the run it gates) silently report
    "cpu".  An accelerator pin survives; only cpu leftovers go."""
    env.pop("KARPENTER_TPU_FORCE_CPU", None)
    if env.get("KARPENTER_TPU_PLATFORM") == "cpu":
        env.pop("KARPENTER_TPU_PLATFORM")
    if env.get("JAX_PLATFORMS") == "cpu":
        env.pop("JAX_PLATFORMS")
    return env


def probe_backend(platform: Optional[str], timeout_s: float,
                  log=None) -> dict:
    """Initialize CUDA in a THROWAWAY subprocess with a hard kill timeout
    — the only way to survive an init that hangs rather than raises.
    Returns an evidence record: ``outcome`` ok|hang|error, plus the
    obtained ``platform`` and card ``count`` on ok, ``no_device`` on a
    host without a card, and on failure the rc, stderr tail and the
    listening ports."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    env = dict(os.environ)
    if platform:
        env.pop("KARPENTER_TPU_FORCE_CPU", None)
        env["KARPENTER_TPU_PLATFORM"] = platform
    else:
        scrub_cpu_overrides(env)
    env["PYTHONPATH"] = repo_root() + os.pathsep + env.get("PYTHONPATH", "")
    rec = {"stage": "probe", "want": platform or "cuda",
           "listening_ports": listening_ports(), "ts": time.time()}
    t0 = time.monotonic()
    try:
        proc = subprocess.run([sys.executable, "-c", PROBE_CODE], env=env,
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        err = (e.stderr or b"")
        if isinstance(err, bytes):
            err = err.decode(errors="replace")
        rec.update(outcome="hang", timeout_s=timeout_s,
                   stderr_tail=err.strip()[-400:])
        log(f"[platform] probe hung past {timeout_s:.0f}s (CUDA init "
            "wedged — card held elsewhere or the driver resetting?); "
            f"listening_ports={rec['listening_ports']}")
        return rec
    rec["probe_secs"] = round(time.monotonic() - t0, 1)
    # the marker must be the first token of its own line: a library
    # writing to stdout without a trailing newline must neither fake a
    # success nor crash the parse
    lines = proc.stdout.splitlines()
    ok_line = next((ln for ln in lines if ln.startswith("PROBE-OK ")), None)
    if proc.returncode == 0 and ok_line:
        _, plat, count = ok_line.split()[:3]
        rec.update(outcome="ok", platform=plat, count=int(count))
        return rec
    tail = (proc.stderr or proc.stdout).strip()
    rec.update(outcome="error", rc=proc.returncode,
               stderr_tail=tail[-400:])
    if proc.returncode == _NODEV_RC and "PROBE-NODEV" in lines:
        rec["no_device"] = True
        log("[platform] probe: no CUDA device on this host")
    else:
        log(f"[platform] probe failed rc={proc.returncode}: "
            f"{tail.splitlines()[-1][:200] if tail else '<no output>'}")
    return rec


def initialize(platform: Optional[str] = None, retries: int = 3,
               backoff_s: float = 5.0, probe_timeout_s: Optional[float] = None,
               log=None) -> str:
    """Probe the card out of process, then configure (build the kernels);
    returns ``"cuda"``, or ``"cpu"`` when the CPU was asked for
    explicitly (argument, KARPENTER_TPU_PLATFORM=cpu or
    KARPENTER_TPU_FORCE_CPU).

    Between failed probes: names the processes that may hold the card
    (it never signals them: the card's list holds every tenant's
    processes) and retries with backoff.  A host with no card at all is
    not retried.  When no probe succeeds it raises RuntimeError: there is
    no fallback to the CPU."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    want = _check(platform or _env_platform() or "cuda")
    if want == "cpu":
        return configure("cpu")
    if probe_timeout_s is None:
        probe_timeout_s = float(os.environ.get(
            "KARPENTER_TPU_PROBE_TIMEOUT", "180"))
    rec: dict = {}
    for attempt in range(max(1, retries)):
        rec = probe_backend(want, probe_timeout_s, log)
        if rec["outcome"] == "ok":
            return configure(want)
        if rec.get("no_device"):
            break  # nothing to wait for
        for pid, args in _other_device_holders():
            log(f"[platform] possible device holder: pid {pid}: {args[:120]}")
        if attempt + 1 < retries:
            time.sleep(backoff_s * (attempt + 1))
    why = ("no CUDA device on this host" if rec.get("no_device")
           else f"the CUDA probe's outcome was {rec.get('outcome')!r}"
           + (f": {rec['stderr_tail'][-200:]}" if rec.get("stderr_tail")
              else ""))
    raise RuntimeError(
        f"no CUDA card available ({why}); this process runs on the card "
        "and does not fall back to the CPU — set KARPENTER_TPU_PLATFORM=cpu "
        "to run the kernels' plain versions on the CPU")
