"""The port's loader of the native (C++) host fast paths.

`native/hostops.cc` at the repository root builds the CPython extension
`kt_hostops` (`make -s hostops` in `native/`, g++ and the CPython headers;
about 3 s).  It owns the host loops around the device solve: the pod
grouping of `solver/encode.group_pods` and, in `TorchSolver._decode`, the
distribution of each class's pods over the kernel's rows (`distribute`),
the used-row identity ids (`row_ids`) and the per-node claim stamping
(`build_claims`).  It reads pods and claims only through attribute names
(`meta.name`, `requests.sort_key()`, `_sched_group_id` /
`scheduling_group_id()`, `pods`, `hostname`, `PodSegments._segs/_tail`),
which the port's model classes carry with the same meaning, so the port
loads the same extension the JAX package does.

The extension is optional: if `native/build/` holds a compiled
`kt_hostops` it is loaded, otherwise ONE `make -s hostops` is tried, and
any failure leaves the pure-Python paths (`group_pods_py`, the Python
distribute and claim loops), which are also the differential-test
oracle.  `KARPENTER_TPU_NO_NATIVE=1` disables both the build and the load
and pins the Python paths.  `build_error()` holds what the failed build
or load said, for callers that must not fall back silently.

The module registers in `sys.modules` as `kt_hostops` only if no other
loader did: a process that loads the JAX package's loader too shares the
entry, and both hold modules of the same stateless extension.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")

_hostops = None
_attempted = False
_error: Optional[str] = None
_build_lock = threading.Lock()


def _ext_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD_DIR, f"kt_hostops{suffix}")


def _load(path: str):
    spec = importlib.util.spec_from_file_location("kt_hostops", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules.setdefault("kt_hostops", mod)
    return mod


def hostops() -> Optional[object]:
    """The kt_hostops module, building it on first use; None if
    unavailable or pinned off by KARPENTER_TPU_NO_NATIVE.

    The build runs at most once per process, under a lock: two callers
    racing here must not spawn two `make`s over one output file.  Call
    this at startup — GatedSolver does — so the compiler never runs
    inside a solve."""
    global _hostops, _attempted, _error
    if _hostops is not None:
        return _hostops
    from karpenter_tpu_torch.utils.knobs import env_bool
    if env_bool("KARPENTER_TPU_NO_NATIVE"):
        return None
    with _build_lock:
        if _attempted:
            return _hostops
        _attempted = True
        path = _ext_path()
        try:
            if not os.path.exists(path):
                # the compiler runs under _build_lock on purpose: see the
                # docstring
                subprocess.run(
                    ["make", "-s", "hostops"], cwd=_NATIVE_DIR, timeout=120,
                    check=True, capture_output=True, text=True)
            _hostops = _load(path)
        except subprocess.CalledProcessError as e:
            _error = f"make hostops exited {e.returncode}:\n{e.stderr}"
        except (OSError, ImportError, subprocess.TimeoutExpired) as e:
            _error = f"{type(e).__name__}: {e}"
    return _hostops


def build_error() -> Optional[str]:
    """Why `hostops()` returned None after a build or load attempt (make's
    stderr, or the loader's error); None when it loaded or never ran."""
    return _error
