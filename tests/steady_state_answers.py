"""The JAX package's answers that `chip_smoke.py` pins for the steady
state: `CONFIG7`, `CONFIG12` and `CONFIG13` (the sha256
`chip_smoke.result_digest` of each pass's canonical result).

Run on the CPU from the repository root:

    JAX_PLATFORMS=cpu python tests/steady_state_answers.py 7 18
    JAX_PLATFORMS=cpu python tests/steady_state_answers.py 13 50000 11
    JAX_PLATFORMS=cpu python tests/steady_state_answers.py 12

Each builds its input with the benchmark's own builders
(`benchmarks/config7_churn.py`, `config13_warm_million.py`,
`config12_megascale.py`), solves every pass on one
`TPUSolver(max_nodes=2048, mesh="off")` with its default knobs, and prints
one line per pass and the digests as JSON.  Not a test: pytest does not
collect it.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv):
    import chip_smoke
    from karpenter_tpu.models import NodePool, ObjectMeta
    from karpenter_tpu.providers import generate_catalog
    from karpenter_tpu.scheduling import ScheduleInput
    from karpenter_tpu.solver import TPUSolver

    solver = TPUSolver(max_nodes=2048, mesh="off")
    pool = NodePool(meta=ObjectMeta(name="default"))
    which = argv[0]
    if which == "7":
        from benchmarks import config7_churn as c7
        catalog, existing = generate_catalog(), c7.build_existing(256)
        inputs = (lambda g=g: ScheduleInput(
            pods=c7.build_pods(g), nodepools=[pool],
            instance_types={"default": catalog},
            existing_nodes=list(existing)) for g in range(int(argv[1])))
    elif which == "13":
        from benchmarks import config13_warm_million as c13
        total = int(argv[1])
        existing = c13.build_existing(256)
        catalog = c13.build_catalog(max(c13.class_counts(total)))
        pop = c13.Population(total)

        def at(g):
            if g:
                pop.advance(g)
            return ScheduleInput(pods=pop.pods(), nodepools=[pool],
                                 instance_types={"default": catalog},
                                 existing_nodes=list(existing))
        inputs = (lambda g=g: at(g) for g in range(int(argv[2])))
    elif which == "12":
        from benchmarks import config12_megascale as c12
        pods, catalog = c12.build_pods(), generate_catalog()
        inputs = [lambda: ScheduleInput(pods=list(pods), nodepools=[pool],
                                        instance_types={"default": catalog})]
    else:
        raise SystemExit(f"unknown config {which!r}: 7, 12 or 13")
    digests = []
    for i, build in enumerate(inputs):
        res = solver.solve(build())
        digests.append(chip_smoke.result_digest(res))
        print(i, res.node_count(), len(res.unschedulable),
              res.total_price().hex(), digests[-1], flush=True)
    print(json.dumps(digests))


if __name__ == "__main__":
    main(sys.argv[1:])
