"""The port's post-mortem tools: `python -m karpenter_tpu_torch.tools.
kt_replay` and `python -m karpenter_tpu_torch.tools.kt_explain`, the
port's twins of the repository's `tools/kt_replay.py` and
`tools/kt_explain.py`, replaying a flight capture on `TorchSolver`."""
