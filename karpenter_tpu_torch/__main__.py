"""`python -m karpenter_tpu_torch` — the operator entry point (the
reference's cmd/controller/main.go:31-74 single binary).  It runs on the
card unless KARPENTER_TPU_PLATFORM=cpu or KARPENTER_TPU_FORCE_CPU asks
for the CPU."""

import sys

from karpenter_tpu_torch.operator.operator import main

if __name__ == "__main__":
    sys.exit(main())
