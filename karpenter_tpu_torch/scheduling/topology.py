"""Topology accounting: spread constraints and pod (anti-)affinity.

Implements the constraint surface documented at
website/content/en/preview/concepts/scheduling.md:209-417 in the reference —
topologySpreadConstraints over zone/hostname/capacity-type honoring
maxSkew/minDomains, and required pod affinity/anti-affinity (with the k8s
symmetry rule: placed pods' required anti-affinity also excludes incoming
pods).

The tracker is incremental: the scheduler registers each placement
(existing pods up front, then simulated assignments as it packs), and asks
which domains remain allowed for the next pod.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import Pod, TopologySpreadConstraint

Selector = FrozenSet[Tuple[str, str]]


def _sel(selector: Dict[str, str]) -> Selector:
    return frozenset(selector.items())


def _matches(selector: Selector, labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector)


class TopologyTracker:
    def __init__(self) -> None:
        # (topology_key, selector) → Counter{domain: matching pod count}.
        # One shared cache serves both spread skew counts and affinity
        # queries — they are the same aggregation.
        # _placed entries: (labels, domains, required-anti (key, selector)
        # pairs). `domains` is stored BY REFERENCE: a new sim's domains
        # dict may gain entries later when the claim pins (e.g. zone), and
        # the caller then calls invalidate_counts() to rebuild the caches
        # so resident pods count in their finally-determined domain.
        self._placed: List[Tuple[Dict[str, str], Dict[str, str],
                                 List[Tuple[str, Selector]]]] = []
        self._match_cache: Dict[Tuple[str, Selector], Counter] = {}
        # symmetric anti-affinity: placed pods' anti terms
        # (topology_key, selector) → set of domains holding such a pod
        self._anti_terms: Dict[Tuple[str, Selector], Set[str]] = defaultdict(set)
        # domains that exist in the cluster per topology key (for minDomains
        # and for "spread over what" decisions)
        self.known_domains: Dict[str, Set[str]] = defaultdict(set)

    # -- registration ----------------------------------------------------
    def observe_domains(self, topology_key: str, domains: "List[str] | Set[str]") -> None:
        self.known_domains[topology_key].update(domains)

    def register(self, pod: Pod, node_domains: Dict[str, str]) -> None:
        """Record a placement. node_domains maps topology key → domain value
        (e.g. zone → us-a, hostname → node-3, capacity-type → spot) and is
        kept by reference — see __init__.
        """
        labels = pod.meta.labels
        for (tkey, sel), counter in self._match_cache.items():
            if tkey in node_domains and _matches(sel, labels):
                counter[node_domains[tkey]] += 1
        # promoted (soft-origin) anti terms bind only the pod's own
        # placement: the k8s symmetry rule applies to REQUIRED anti only,
        # so a preferred anti must never hard-block other pods
        anti = [(t.topology_key, _sel(t.label_selector))
                for t in pod.pod_affinities
                if t.anti and t.required and not t.promoted]
        self._placed.append((dict(labels), node_domains, anti))
        for tkey, sel in anti:
            if tkey in node_domains:
                self._anti_terms[(tkey, sel)].add(node_domains[tkey])
        for tkey, domain in node_domains.items():
            self.known_domains[tkey].add(domain)

    def snapshot(self) -> tuple:
        """A value snapshot of the tracker's whole mutable state, for
        the oracle's atomic gang trials: a failed trial must
        roll back every registration it made.  Placements are truncated
        by length (entries are append-only); the caches/sets are copied
        by value."""
        return (len(self._placed),
                {k: Counter(v) for k, v in self._match_cache.items()},
                {k: set(v) for k, v in self._anti_terms.items()},
                {k: set(v) for k, v in self.known_domains.items()})

    def restore(self, snap: tuple) -> None:
        n, match_cache, anti_terms, known = snap
        del self._placed[n:]
        self._match_cache = match_cache
        self._anti_terms = defaultdict(set)
        for k, v in anti_terms.items():
            self._anti_terms[k] = v
        self.known_domains = defaultdict(set)
        for k, v in known.items():
            self.known_domains[k] = v

    def invalidate_counts(self) -> None:
        """Rebuild domain-keyed caches after a registered node's domains
        dict gained an entry (a claim pinned an undetermined zone/
        capacity-type): its resident pods must count in the new domain."""
        self._match_cache.clear()
        self._anti_terms = defaultdict(set)
        for _labels, domains, anti in self._placed:
            for tkey, sel in anti:
                if tkey in domains:
                    self._anti_terms[(tkey, sel)].add(domains[tkey])
            for tkey, domain in domains.items():
                self.known_domains[tkey].add(domain)

    def ensure_spread_counter(self, constraint: TopologySpreadConstraint) -> Counter:
        return self._matching_counts(constraint.topology_key,
                                     _sel(constraint.label_selector))

    def counts_for(self, topology_key: str, selector: Dict[str, str]) -> Counter:
        """Matching-pod counts per domain for an arbitrary (key, selector) —
        the solver encoder's view of the same aggregation the oracle uses."""
        return self._matching_counts(topology_key, _sel(selector))

    def _matching_counts(self, topology_key: str, selector: Selector) -> Counter:
        key = (topology_key, selector)
        if key not in self._match_cache:
            counter = Counter()
            for labels, domains, _anti in self._placed:
                if topology_key in domains and _matches(selector, labels):
                    counter[domains[topology_key]] += 1
            self._match_cache[key] = counter
        return self._match_cache[key]

    # -- queries ---------------------------------------------------------
    def eligible_domains(self, pod: Pod, topology_key: str) -> Set[str]:
        """Domains the pod could ever use for a key: all the cluster knows,
        filtered by the pod's own hard requirement on that key (k8s
        nodeAffinityPolicy: Honor — domains the pod's affinity excludes do
        not participate in skew)."""
        known = self.known_domains.get(topology_key, set())
        req = pod.requirements.get(topology_key)
        if req is None:
            return set(known)
        return {d for d in known if req.matches(d)}

    def spread_allowed_domains(
        self,
        pod: Pod,
        constraint: TopologySpreadConstraint,
        candidate_domains: Set[str],
    ) -> Set[str]:
        """Domains where adding this pod keeps skew ≤ maxSkew (DoNotSchedule).

        Skew is measured over the *eligible* domain set — every domain the
        pod could use given its own node constraints, with empty eligible
        domains counting as 0. With minDomains set, while fewer than
        minDomains domains hold matching pods, the global minimum is treated
        as 0, forcing spreading to empty domains.
        """
        if constraint.when_unsatisfiable != "DoNotSchedule":
            return set(candidate_domains)
        counts = self.ensure_spread_counter(constraint)
        eligible = set(candidate_domains) | self.eligible_domains(
            pod, constraint.topology_key)
        if not eligible:
            return set(candidate_domains)
        if constraint.topology_key == wellknown.HOSTNAME_LABEL:
            # the provisioner can always mint a fresh, empty hostname
            # domain (a new node), so the global minimum is 0 — maxSkew
            # becomes a per-node ceiling, which is what hostname spread
            # means to users ("at most N pods of this set per node")
            global_min = 0
        else:
            global_min = min(counts.get(d, 0) for d in eligible)
        if constraint.min_domains is not None:
            populated = sum(1 for d in eligible if counts.get(d, 0) > 0)
            if populated < constraint.min_domains:
                global_min = 0
        return {
            d for d in candidate_domains
            if counts.get(d, 0) + 1 - global_min <= constraint.max_skew
        }

    def affinity_allowed_domains(
        self, pod: Pod, candidate_domains: Set[str], topology_key: str,
        selector: Dict[str, str],
    ) -> Set[str]:
        """Required pod-affinity: restrict to domains already holding a
        matching pod. If none exists anywhere, a self-matching pod may seed
        any domain (the standard bootstrap carve-out); otherwise nothing
        is allowed.
        """
        counts = self._matching_counts(topology_key, _sel(selector))
        populated = {d for d, c in counts.items() if c > 0}
        if populated:
            return candidate_domains & populated
        if _matches(_sel(selector), pod.meta.labels):
            return set(candidate_domains)  # seeds the domain
        return set()

    def anti_affinity_blocked_domains(
        self, pod: Pod, topology_key: str, selector: Dict[str, str],
    ) -> Set[str]:
        """Domains excluded by the pod's own required anti-affinity."""
        counts = self._matching_counts(topology_key, _sel(selector))
        return {d for d, c in counts.items() if c > 0}

    def symmetric_anti_blocked_domains(self, pod: Pod, topology_key: str) -> Set[str]:
        """Domains excluded because an already-placed pod's required
        anti-affinity matches this pod."""
        blocked: Set[str] = set()
        for (tkey, sel), domains in self._anti_terms.items():
            if tkey == topology_key and _matches(sel, pod.meta.labels):
                blocked |= domains
        return blocked

    def anti_topology_keys(self) -> Set[str]:
        return {tkey for (tkey, _sel_) in self._anti_terms.keys()}


def node_domains_for(labels: Dict[str, str], hostname: str) -> Dict[str, str]:
    """The topology domains a node provides, from its labels."""
    domains = {wellknown.HOSTNAME_LABEL: hostname}
    for key in (wellknown.ZONE_LABEL, wellknown.CAPACITY_TYPE_LABEL,
                wellknown.REGION_LABEL, wellknown.NODEPOOL_LABEL):
        if key in labels:
            domains[key] = labels[key]
    return domains
