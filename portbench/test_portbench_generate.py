"""The seeded generators are deterministic, and every seed gives the same
work in another order."""

from portbench import generate

BIG_SEED = 2 ** 40 + 12345


def _burst_key(b):
    p = b["pods"]
    return (p["name"], p["requests"].tolist(), p["zone"], p["tolerate"])


def test_bursts_repeat_for_a_seed():
    cfg = generate.load_config("burst50k")
    tr = generate.load_traffic("cold")
    a = generate.bursts(cfg, tr, BIG_SEED)
    b = generate.bursts(cfg, tr, BIG_SEED)
    assert [_burst_key(x) for x in a] == [_burst_key(x) for x in b]
    c = generate.bursts(cfg, tr, BIG_SEED + 1)
    assert _burst_key(a[0]) != _burst_key(c[0])


def test_a_ring_holds_the_configuration_counts():
    for name, mix in (("burst50k", "cold"), ("mixed5k", "cards4")):
        cfg = generate.load_config(name)
        tr = generate.load_traffic(mix)
        ring = generate.bursts(cfg, tr, BIG_SEED)
        assert len(ring) == tr["ring"]
        n = sum(c["count"] for c in cfg["classes"])
        assert all(len(b["pods"]["name"]) == n for b in ring)
        keys = [(tuple(generate.catalog.vector(c["requests"])), c.get("zone"),
                 bool(c.get("tolerate", False))) for c in cfg["classes"]]
        total = dict.fromkeys(keys, 0)
        for b in ring:
            p = b["pods"]
            for row, z, t in zip(p["requests"], p["zone"], p["tolerate"]):
                total[(tuple(row), z, t)] += 1
        assert [total[k] for k in keys] == [tr["ring"] * c["count"]
                                            for c in cfg["classes"]]


def test_candidate_sets_repeat_and_differ_by_call():
    cfg = generate.load_config("consolidate2k")
    for mix in ("single", "multi"):
        tr = generate.load_traffic(mix)
        a = generate.candidate_sets(cfg, tr, BIG_SEED, 7)
        assert a == generate.candidate_sets(cfg, tr, BIG_SEED, 7)
        assert a != generate.candidate_sets(cfg, tr, BIG_SEED, 8)
        assert len(a) == tr["sims"]
        assert all(len(set(c)) == len(c) for c in a)
    tr = generate.load_traffic("multi")
    sets = generate.candidate_sets(cfg, tr, BIG_SEED, 0)
    assert [len(c) for c in sets] == list(range(100, 36, -1))
    assert all(sets[i][:len(sets[i + 1])] == sets[i + 1]
               for i in range(len(sets) - 1))


def test_fleet_matches_config4():
    cfg = generate.load_config("consolidate2k")
    fl = generate.fleet(cfg)
    assert len(fl["name"]) == 2000
    assert fl["labels"][4]["topology.kubernetes.io/zone"] == "tpu-west-1b"
    assert fl["labels"][3]["karpenter.sh/capacity-type"] == "on-demand"
    assert fl["available"][0].tolist() == [15500.0, 31744.0, 0.0, 58.0,
                                           0.0, 0.0]
