"""Admission control: queue-depth rejection and per-tenant in-flight budgets
(counterpart of `hyperspace_tpu/serve/admission.py`, same env knobs,
messages and metric names).

Two invariants, checked when a query is submitted, before it is queued:

- Queue depth (`HYPERSPACE_SERVE_QUEUE_DEPTH`, 256): admitted but
  unfinished queries the server holds. Past it a submission fails at once
  with `AdmissionRejectedError(reason="queue_depth")`.
- Tenant budget (`HYPERSPACE_SERVE_TENANT_BUDGET`, 0 = unlimited):
  in-flight (queued or running) queries one tenant may hold; past it that
  tenant gets `AdmissionRejectedError(reason="tenant_budget")` while the
  others keep flowing.

In a replica fleet (`HYPERSPACE_REPLICAS=1`, `serve.replicas`) the tenant
budget is the fleet's: each replica enforces ceil(budget / live replicas),
at least 1, read from the live membership at every admit, so a replica
that joins or dies rebalances the shares.

`serve.admit` is a fault point (`telemetry.faults`), checked first: an
injected fault is a failure of admission, not a rejection.

Metrics: `serve.admitted`, `serve.rejected.queue_depth`,
`serve.rejected.tenant_budget` and the `serve.tenants.active` gauge.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

from ..exceptions import AdmissionRejectedError
from ..telemetry import faults as _faults
from ..telemetry import metrics as _metrics

ENV_QUEUE_DEPTH = "HYPERSPACE_SERVE_QUEUE_DEPTH"
ENV_TENANT_BUDGET = "HYPERSPACE_SERVE_TENANT_BUDGET"

_DEFAULT_QUEUE_DEPTH = 256
_DEFAULT_TENANT_BUDGET = 0  # unlimited

_ADMITTED = _metrics.counter("serve.admitted")
_REJECTED_DEPTH = _metrics.counter("serve.rejected.queue_depth")
_REJECTED_TENANT = _metrics.counter("serve.rejected.tenant_budget")
_TENANTS_ACTIVE = _metrics.gauge("serve.tenants.active")


def default_queue_depth() -> int:
    try:
        return max(1, int(os.environ.get(ENV_QUEUE_DEPTH, "") or _DEFAULT_QUEUE_DEPTH))
    except ValueError:
        return _DEFAULT_QUEUE_DEPTH


def default_tenant_budget() -> int:
    """0 = unlimited: a default cap would reject what a single caller runs."""
    try:
        return max(0, int(os.environ.get(ENV_TENANT_BUDGET, "") or _DEFAULT_TENANT_BUDGET))
    except ValueError:
        return _DEFAULT_TENANT_BUDGET


class AdmissionController:
    """In-flight tokens of one `QueryServer`: `admit` grants one (release it
    in a `finally`) or raises; it never blocks."""

    def __init__(self, queue_depth=None, tenant_budget=None):
        self.queue_depth = default_queue_depth() if queue_depth is None else max(1, int(queue_depth))
        self.tenant_budget = default_tenant_budget() if tenant_budget is None else max(0, int(tenant_budget))
        self._lock = threading.Lock()
        self._in_flight = 0
        self._per_tenant: Dict[str, int] = {}

    def effective_tenant_budget(self) -> int:
        """The budget this replica enforces now: its fleet share, or the
        configured budget outside a fleet."""
        if not self.tenant_budget:
            return self.tenant_budget
        from . import replicas as _replicas

        return _replicas.apportioned_budget(self.tenant_budget)

    def admit(self, tenant: str) -> None:
        """Grant `tenant` one token or raise `AdmissionRejectedError`."""
        _faults.check("serve.admit")
        budget = self.effective_tenant_budget()
        with self._lock:
            if self._in_flight >= self.queue_depth:
                _REJECTED_DEPTH.inc()
                raise AdmissionRejectedError(
                    f"server at HYPERSPACE_SERVE_QUEUE_DEPTH={self.queue_depth} in-flight queries; rejecting "
                    f"tenant '{tenant}' (retry with backoff)",
                    reason="queue_depth",
                    tenant=tenant,
                )
            held = self._per_tenant.get(tenant, 0)
            if budget and held >= budget:
                _REJECTED_TENANT.inc()
                raise AdmissionRejectedError(
                    f"tenant '{tenant}' at HYPERSPACE_SERVE_TENANT_BUDGET={self.tenant_budget} (this replica's "
                    f"fleet share: {budget}) in-flight queries; rejecting (other tenants are unaffected)",
                    reason="tenant_budget",
                    tenant=tenant,
                )
            self._in_flight += 1
            self._per_tenant[tenant] = held + 1
            _TENANTS_ACTIVE.set(len(self._per_tenant))
        _ADMITTED.inc()

    def release(self, tenant: str) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            held = self._per_tenant.get(tenant, 0) - 1
            if held <= 0:
                self._per_tenant.pop(tenant, None)
            else:
                self._per_tenant[tenant] = held
            _TENANTS_ACTIVE.set(len(self._per_tenant))

    def stats(self) -> dict:
        effective = self.effective_tenant_budget()
        with self._lock:
            out = {
                "in_flight": self._in_flight,
                "queue_depth": self.queue_depth,
                "tenant_budget": self.tenant_budget,
                "per_tenant": dict(self._per_tenant),
            }
        if effective != self.tenant_budget:
            out["tenant_budget_fleet_share"] = effective
        return out
