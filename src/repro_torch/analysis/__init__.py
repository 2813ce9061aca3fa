"""Correctness tooling for the batch engine, as in the reference package's
``analysis`` (its static analyzer, barqlint, lints this package's sources
from there):

  * ``repro_torch.analysis.plan_verify`` — **PlanVerifier**, a
    post-planning structural checker the Engine runs under
    ``EngineConfig.verify_plans``: sortedness claims, SIP soundness,
    grace/adaptive gating, fingerprint and schema coverage.
  * ``repro_torch.analysis.sanitize`` — **pool sanitizer**, a runtime
    shadow ownership tracker enabled by ``EngineConfig.sanitize``: poisoned
    releases on the buffers' device, double-release / use-after-release
    errors attributed to the allocating operator, and leak reports at
    drain.
"""

_EXPORTS = {
    "PlanInvariantError": "plan_verify",
    "verify_plan": "plan_verify",
    "PoolSanitizer": "sanitize",
    "SanitizeError": "sanitize",
    "SanitizingBatchPool": "sanitize",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"repro_torch.analysis.{mod}"), name)


__all__ = list(_EXPORTS)
