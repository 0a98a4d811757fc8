"""Compare the catalog's COMPUTED allocatable against what a live node
actually reports: drift between the scheduler's capacity model and
kubelet reality silently over- or under-packs nodes.

The port's twin of `tools/allocatable_diff.py`, through the port's
`env.Environment`, its solver on the card unless `--device cpu` asks
for the CPU.  "Live" is a node provisioned through the full controller
stack in the fake cloud (the same claim → launch → register path a real
node takes), optionally under a NodeClass with a kubelet maxPods, so
the allocatable math (providers/instancetype.apply_node_class) is
exercised end to end.

Usage:
    python -m karpenter_tpu_torch.tools.allocatable_diff [--types m6.large,c6.xlarge] [--max-pods N] [--device cpu]

Exit code 1 if any type diverges (or no card was found without
`--device cpu`).
"""

import argparse
import sys

# the default sample: the reference's four families and sizes as the
# generated catalog names them (its own sample, "m6.large", "c6.2xlarge",
# "r7.4xlarge" and "m6d.2xlarge", names types that catalog does not
# hold, so the reference exits 1 on "unknown types" without --types)
SAMPLE_TYPES = ("m6i.large", "c6i.2xlarge", "r7i.4xlarge", "m6id.2xlarge")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.tools.allocatable_diff")
    ap.add_argument("--types", default="",
                    help="comma-separated type names (default: a sample)")
    ap.add_argument("--max-pods", type=int, default=None,
                    help="kubelet maxPods override to exercise")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the solver's device (default: the card)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.tools import device
    dev = device(args.device, "allocatable-diff")
    from karpenter_tpu_torch.env import Environment
    from karpenter_tpu_torch.models import (
        KubeletConfiguration, NodePool, ObjectMeta, Pod, Requirement,
        Requirements, Resources, wellknown)
    from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
    from karpenter_tpu_torch.operator.options import Options

    env = Environment(options=Options(batch_idle_duration=0), device=dev)
    nc = env.add_default_nodeclass()
    if args.max_pods is not None:
        nc.kubelet = KubeletConfiguration(max_pods=args.max_pods)
        env.cluster.nodeclasses.update(nc)
    env.cluster.nodepools.create(NodePool(meta=ObjectMeta(name="default")))

    names = [t for t in args.types.split(",") if t] or list(SAMPLE_TYPES)
    computed = {it.name: it
                for it in env.instance_types.list(nc) if it.name in names}
    missing = set(names) - set(computed)
    if missing:
        print(f"unknown types: {sorted(missing)}", file=sys.stderr)
        return 1

    rc = 0
    for name in names:
        it = computed[name]
        # provision one node of exactly this type
        pod = Pod(meta=ObjectMeta(name=f"probe-{name.replace('.', '-')}"),
                  requests=Resources.parse({"cpu": "100m", "memory": "128Mi"}))
        pod.requirements = Requirements(Requirement.make(
            wellknown.INSTANCE_TYPE_LABEL, "In", name))
        env.cluster.pods.create(pod)
        env.settle()
        live = env.cluster.nodes.get(pod.node_name)
        if live is None:
            print(f"{name}: FAILED to provision", file=sys.stderr)
            rc = 1
            continue
        want = it.allocatable()
        diffs = []
        for axis, w, g in zip(RESOURCE_AXIS, want.v, live.allocatable.v):
            if abs(w - g) > 1e-6:
                diffs.append(f"{axis}: computed={w:.1f} live={g:.1f}")
        status = "OK" if not diffs else "DIVERGED " + "; ".join(diffs)
        if diffs:
            rc = 1
        print(f"{name:16s} {status}")
        env.cluster.pods.delete(pod.meta.name)
        env.settle()
    return rc


if __name__ == "__main__":
    sys.exit(main())
