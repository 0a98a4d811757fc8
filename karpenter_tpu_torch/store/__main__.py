"""`python -m karpenter_tpu_torch.store <socket-path>` — run a standalone
store daemon (the deploy/ manifests' apiserver-analogue service; see
docs/store-backends.md).  The port's copy of `karpenter_tpu/store/
__main__.py`: it imports no torch device state."""

import signal
import sys
import threading

from karpenter_tpu_torch.store import StoreDaemon


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/karpenter-store.sock"
    daemon = StoreDaemon(path)
    stop = threading.Event()
    # the handlers before the banner: a caller may signal the moment it
    # reads the banner, and a SIGTERM before them would end the process
    # with no exit code of its own
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"karpenter-tpu store daemon: {path}", flush=True)
    stop.wait()
    daemon.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
