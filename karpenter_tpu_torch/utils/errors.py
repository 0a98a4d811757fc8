"""Cloud error taxonomy — classification driving retry/ICE behavior.

Mirrors pkg/errors/errors.go:57-100: IsNotFound (delete of a gone resource
is success), IsUnfulfillableCapacity (the ICE code list — feeds the
unavailable-offerings cache instead of failing the claim), and
IsLaunchTemplateNotFound (invalidate cache + retry once).
"""

from __future__ import annotations


def is_not_found(err: BaseException) -> bool:
    from karpenter_tpu_torch.providers.fake_cloud import CloudAPIError
    return isinstance(err, CloudAPIError) and "not found" in str(err).lower()


def is_unfulfillable_capacity(err: BaseException) -> bool:
    """The insufficient-capacity error class: retry in a different pool,
    never fail provisioning outright (errors.go ICE code list)."""
    from karpenter_tpu_torch.cloudprovider.provider import InsufficientCapacity
    return isinstance(err, InsufficientCapacity)


def is_launch_template_not_found(err: BaseException) -> bool:
    from karpenter_tpu_torch.providers.fake_cloud import LaunchTemplateNotFound
    return isinstance(err, LaunchTemplateNotFound)


def is_retryable(err: BaseException) -> bool:
    """Transient cloud unavailability: keep the claim and retry the next
    reconcile (the liveness/backoff path, SURVEY §5 failure detection)."""
    from karpenter_tpu_torch.providers.fake_cloud import CloudAPIError
    return (isinstance(err, CloudAPIError)
            and not is_not_found(err)
            and not is_launch_template_not_found(err))
