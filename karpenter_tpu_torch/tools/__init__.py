"""The port's operator tools, each run as `python -m
karpenter_tpu_torch.tools.<tool>`, the port's twins of the repository's
`tools/`, `hack/determinism_harness.py` and `deploy/run_ha.py`:

  kt_replay        replay a flight capture, bit-identical or exit 1
  kt_explain       a stranded pod's constraint-elimination tree
  kt_ledger        the fleet spend/savings report over ledger records
  kt_rewind        replay a timeline with the trajectory invariants armed
  allocatable_diff the catalog's allocatable against a provisioned node
  determinism      the double-run digest compare across hash seeds
  run_ha           a store daemon and two operator replicas on one lease

The ones that solve run on the card unless `--device cpu` asks for the
CPU (`device`); without a card they exit non-zero, as the operator's
probe does."""


def device(want: str, prog: str) -> str:
    """The device a tool runs on: `want` ("cuda" or "cpu"), the card
    probed out of process first and its kernels built
    (`utils/platform.initialize`).  No card exits with the probe's
    reason; there is no fallback to the CPU."""
    from karpenter_tpu_torch.utils.platform import initialize
    try:
        return initialize(want)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{prog}: {e}")
