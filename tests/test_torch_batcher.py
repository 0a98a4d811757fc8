"""The port's request batcher (`utils/batcher.py`) and batched cloud
(`providers/batched_cloud.py`) against the JAX package's: the cases of
`tests/test_batcher.py` — coalescing, windows, hashing, failure fan-out,
and the three batched fleet calls — run on both packages (reference:
pkg/batcher/batcher.go, per-API configs in
pkg/batcher/{createfleet,describeinstances,terminateinstances}.go)."""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest


def _pkg(root):
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    fake = imp("providers.fake_cloud")
    return SimpleNamespace(
        Batcher=imp("utils.batcher").Batcher,
        BatchedCloud=imp("providers.batched_cloud").BatchedCloud,
        FakeCloud=fake.FakeCloud, FleetCandidate=fake.FleetCandidate,
        metrics=imp("utils.metrics"))


PKGS = {"jax": _pkg("karpenter_tpu"), "port": _pkg("karpenter_tpu_torch")}


@pytest.fixture(autouse=True)
def _port_faults_disarmed():
    """tests/conftest.py disarms the JAX package's fault registry around
    every test; the port keeps its own, disarmed here the same way."""
    from karpenter_tpu_torch.utils import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _run_concurrently(fn, args_list):
    results = [None] * len(args_list)
    errors = [None] * len(args_list)
    # every thread calls at once: a loaded host can start threads tens of
    # ms apart, past a batching window
    start = threading.Barrier(len(args_list))

    def work(i, a):
        start.wait()
        try:
            results[i] = fn(a)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i, a))
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


class TestBatcher:
    def test_concurrent_adds_coalesce_into_one_batch(self, pkg):
        calls = []
        b = pkg.Batcher(lambda reqs: (calls.append(list(reqs)), reqs)[1],
                        idle_s=0.05, max_s=1.0, max_items=100)
        results, errors = _run_concurrently(b.add, list(range(10)))
        assert errors == [None] * 10
        assert sorted(results) == list(range(10))
        assert len(calls) == 1 and len(calls[0]) == 10
        assert b.batches_executed == 1 and b.items_batched == 10

    def test_each_caller_gets_its_own_result(self, pkg):
        b = pkg.Batcher(lambda reqs: [r * 2 for r in reqs],
                        idle_s=0.02, max_s=1.0, max_items=100)
        results, _ = _run_concurrently(b.add, [1, 2, 3, 4])
        assert sorted(results) == [2, 4, 6, 8]

    def test_idle_window_separates_batches(self, pkg):
        calls = []
        b = pkg.Batcher(lambda reqs: (calls.append(list(reqs)), reqs)[1],
                        idle_s=0.02, max_s=5.0, max_items=100)
        b.add(1)
        time.sleep(0.08)  # let the window close
        b.add(2)
        assert len(calls) == 2

    def test_max_items_fires_immediately(self, pkg):
        calls = []
        b = pkg.Batcher(lambda reqs: (calls.append(list(reqs)), reqs)[1],
                        idle_s=5.0, max_s=60.0, max_items=4)
        t0 = time.monotonic()
        results, errors = _run_concurrently(b.add, [1, 2, 3, 4])
        assert errors == [None] * 4
        assert time.monotonic() - t0 < 5.0  # did not wait out the idle window
        assert len(calls) == 1

    def test_hasher_buckets_incompatible_requests(self, pkg):
        calls = []
        b = pkg.Batcher(lambda reqs: (calls.append(list(reqs)), reqs)[1],
                        idle_s=0.05, max_s=1.0, max_items=100,
                        hasher=lambda r: r % 2)
        _run_concurrently(b.add, [0, 1, 2, 3])
        assert len(calls) == 2
        assert sorted(len(c) for c in calls) == [2, 2]

    def test_executor_error_fails_every_caller(self, pkg):
        def boom(reqs):
            raise RuntimeError("cloud down")

        b = pkg.Batcher(boom, idle_s=0.02, max_s=1.0, max_items=100)
        results, errors = _run_concurrently(b.add, [1, 2, 3])
        assert all(isinstance(e, RuntimeError) for e in errors)

    def test_overfull_bucket_drains_in_max_items_chunks(self, pkg):
        calls = []
        b = pkg.Batcher(lambda reqs: (calls.append(list(reqs)), reqs)[1],
                        idle_s=0.02, max_s=1.0, max_items=4)
        pendings = [b.submit(i) for i in range(10)]
        results = [b.wait(p) for p in pendings]
        assert sorted(results) == list(range(10))
        assert all(len(c) <= 4 for c in calls)
        assert sum(len(c) for c in calls) == 10

    def test_result_count_mismatch_is_an_error(self, pkg):
        b = pkg.Batcher(lambda reqs: [1], idle_s=0.02, max_s=1.0, max_items=100)
        results, errors = _run_concurrently(b.add, [1, 2])
        assert all(isinstance(e, RuntimeError) for e in errors)


class TestBatchedCloud:
    def _cloud(self, pkg):
        cloud = pkg.FakeCloud()
        bc = pkg.BatchedCloud(cloud)
        # tighten windows so tests run fast
        for b in (bc.terminate_batcher, bc.describe_batcher,
                  bc.fleet_batcher):
            b.idle_s = 0.02
        return cloud, bc

    def _launch(self, pkg, cloud, n):
        out = []
        for _ in range(n):
            inst, _ = cloud.create_fleet(
                [pkg.FleetCandidate("standard-4", "zone-a", "on-demand", 1.0)],
                tags={"karpenter.sh/discovery": "c"})
            out.append(inst)
        return out

    def test_terminate_merges_into_one_api_call(self, pkg):
        cloud, bc = self._cloud(pkg)
        insts = self._launch(pkg, cloud, 6)
        cloud.api_calls.clear()
        ids = [i.instance_id for i in insts]
        results, errors = _run_concurrently(
            lambda iid: bc.terminate_instances([iid]), ids)
        assert errors == [None] * 6
        assert all(r == [iid] for r, iid in zip(results, ids))
        terminate_calls = [c for c in cloud.api_calls
                           if c[0] == "TerminateInstances"]
        assert len(terminate_calls) == 1
        assert all(cloud.instances[i].state == "terminated" for i in ids)

    def test_one_callers_id_list_shares_one_call(self, pkg):
        cloud, bc = self._cloud(pkg)
        insts = self._launch(pkg, cloud, 5)
        cloud.api_calls.clear()
        ids = [i.instance_id for i in insts]
        t0 = time.monotonic()
        done = bc.terminate_instances(ids)
        elapsed = time.monotonic() - t0
        assert done == ids
        terminate_calls = [c for c in cloud.api_calls
                           if c[0] == "TerminateInstances"]
        assert len(terminate_calls) == 1
        # the ids rode ONE window, not one 100ms window each
        assert elapsed < 0.5

    def test_terminate_unknown_id_reports_not_terminated(self, pkg):
        _, bc = self._cloud(pkg)
        assert bc.terminate_instances(["i-nope"]) == []

    def test_describe_coalesces_identical_filters(self, pkg):
        cloud, bc = self._cloud(pkg)
        self._launch(pkg, cloud, 3)
        cloud.api_calls.clear()
        results, errors = _run_concurrently(
            lambda _: bc.describe_instances(
                tag_filter={"karpenter.sh/discovery": "c"}),
            list(range(5)))
        assert errors == [None] * 5
        assert all(len(r) == 3 for r in results)
        describe_calls = [c for c in cloud.api_calls
                          if c[0] == "DescribeInstances"]
        assert len(describe_calls) == 1

    def test_describe_different_filters_do_not_share_results(self, pkg):
        cloud, bc = self._cloud(pkg)
        inst, _ = cloud.create_fleet(
            [pkg.FleetCandidate("standard-4", "zone-a", "on-demand", 1.0)],
            tags={"karpenter.sh/discovery": "other"})
        results, _ = _run_concurrently(
            lambda f: bc.describe_instances(tag_filter=f),
            [{"karpenter.sh/discovery": "c"},
             {"karpenter.sh/discovery": "other"}])
        lens = sorted(len(r) for r in results)
        assert lens == [0, 1]

    def test_create_fleet_rides_one_window(self, pkg):
        cloud, bc = self._cloud(pkg)
        # a window wide enough for four concurrent calls on a loaded host
        bc.fleet_batcher.idle_s = 0.25
        reqs = [
            ([pkg.FleetCandidate("standard-4", "zone-a", "on-demand", 1.0)],
             {"karpenter.sh/nodeclaim": f"nc-{i}"})
            for i in range(4)
        ]
        results, errors = _run_concurrently(
            lambda r: bc.create_fleet(*r), reqs)
        assert errors == [None] * 4
        insts = [inst for inst, _ice in results]
        assert all(i is not None for i in insts)
        assert len({i.instance_id for i in insts}) == 4
        assert bc.fleet_batcher.batches_executed == 1

    def test_delegates_unbatched_apis(self, pkg):
        cloud, bc = self._cloud(pkg)
        assert bc.live() is True
        assert bc.describe_instance_types() == cloud.describe_instance_types()


def test_batch_sizes_reach_the_metric():
    """Each executed batch observes its size once on the batch-size
    histogram under the batcher's name, in both packages alike."""
    seen = {}
    for name, pkg in PKGS.items():
        h = pkg.metrics.BATCHER_BATCH_SIZE
        n0, s0 = h.count(batcher="probe"), h.sum(batcher="probe")
        b = pkg.Batcher(lambda reqs: reqs, idle_s=0.02, max_s=1.0,
                        max_items=100, name="probe")
        _run_concurrently(b.add, list(range(7)))
        seen[name] = (h.count(batcher="probe") - n0,
                      h.sum(batcher="probe") - s0)
    assert seen["port"] == seen["jax"] == (1, 7.0)
