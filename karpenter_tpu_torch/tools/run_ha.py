"""Supervised-process HA runner — the docker-compose layout without
docker: one store daemon + two operator replica PROCESSES sharing its
socket and a file lease.  Exactly one replica leads; kill it (SIGKILL)
and watch the standby take over within a lease duration.

The port's twin of `deploy/run_ha.py`: it starts `python -m
karpenter_tpu_torch.store <sock>` and two `python -m karpenter_tpu_torch`
replicas, which run on the card (each probes it at boot and exits 1
without one) unless KARPENTER_TPU_PLATFORM=cpu is set.

    python -m karpenter_tpu_torch.tools.run_ha [workdir]

Notes: the operators run against the in-memory fake cloud, which is
per-process — so cloud-side state (instances) is not shared across
replicas here.  Against a real cloud the instances ARE shared (they live
in the cloud), and the failover semantics are the ones
tests/test_torch_ha.py proves in-process with a genuinely shared cloud:
leader killed mid-provisioning, no pods lost.  SIGINT or SIGTERM stops
the store and both replicas.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time

from karpenter_tpu_torch.utils.platform import repo_root

# each replica's (metrics, health) ports
REPLICA_PORTS = ((8000, 8081), (8002, 8083))


def start(workdir: str) -> dict:
    """Start the store daemon on `workdir`/store.sock and one replica a
    (metrics, health) pair of `REPLICA_PORTS` on it and
    `workdir`/lease.json; returns {name: process}."""
    root = repo_root()
    os.makedirs(workdir, exist_ok=True)
    store_sock = os.path.join(workdir, "store.sock")
    lease = os.path.join(workdir, "lease.json")
    env_base = dict(os.environ, PYTHONPATH=root)

    procs = {}
    procs["store"] = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.store", store_sock],
        env=env_base, cwd=root)
    deadline = time.time() + 10
    while not os.path.exists(store_sock) and time.time() < deadline:
        time.sleep(0.05)
    for i, (mport, hport) in enumerate(REPLICA_PORTS, 1):
        procs[f"rep-{i}"] = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch"],
            env=dict(env_base,
                     KARPENTER_TPU_STORE_SOCKET=store_sock,
                     KARPENTER_TPU_LEASE_FILE=lease,
                     KARPENTER_TPU_REPLICA_ID=f"rep-{i}",
                     KARPENTER_TPU_METRICS_PORT=str(mport),
                     KARPENTER_TPU_HEALTH_PORT=str(hport)),
            cwd=root)
    return procs


def stop(procs: dict) -> None:
    """SIGTERM every process, then SIGKILL what has not exited within 10
    s."""
    for p in procs.values():
        p.terminate()
    for p in procs.values():
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main() -> int:
    workdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="kt_ha_")
    procs = start(workdir)
    print(f"HA pair up (workdir={workdir}): store pid "
          f"{procs['store'].pid}, replicas "
          f"{procs['rep-1'].pid}/{procs['rep-2'].pid}. "
          "Kill the leader to watch failover; Ctrl-C to stop.", flush=True)

    def shutdown(*_):
        stop(procs)
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    while True:
        for name, p in list(procs.items()):
            if p.poll() is not None and name.startswith("rep"):
                print(f"{name} exited rc={p.returncode}; the peer holds "
                      "(or takes) the lease", flush=True)
                del procs[name]
        if not any(n.startswith("rep") for n in procs):
            print("both replicas gone; shutting down", flush=True)
            shutdown()
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
