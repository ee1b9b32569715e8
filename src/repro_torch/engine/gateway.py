"""Multi-tenant serving gateway: N tenants, one worker pool, one dispatch
signature cache (port of ``src/repro/engine/gateway.py``; DESIGN.md §15).

A ``ServingGateway`` hosts tenants, each a name bound to an
``IndexArtifact`` version (forward or reverse) and a ``TenantPolicy``
(max k, max tickets in flight, a per-query scan budget, a default
deadline). ``submit(tenant, q)`` checks the policy and dispatches through
the tenant's own ``ServingRuntime``; the gateway adds admission and
routing, never a dispatch path of its own, so a tenant's answers are
bitwise those of a dedicated runtime.

  * One worker pool: every tenant runtime dispatches through one
    ``runtime.WorkerPool``, whose threads skip a tenant whose dispatch
    lock is held, so one tenant's swap or compaction never stalls
    another's traffic.
  * One signature cache: a tenant whose config equals an earlier tenant's
    in every field but ``scan_budget`` adopts that tenant's dispatch
    signature set (``share_dispatch``; engine-level for reverse tenants,
    server-level for forward ones). ``warmup()`` warms one member of each
    share group and re-baselines every member, so
    ``stats().traces_after_warmup`` is 0 for all of them after it.
  * Budgets are visible: a budget-truncated reverse ticket comes back
    ``truncated=True`` with its dispatch's funnel, and the tenant's
    ``RuntimeStats.truncated`` counts it.
  * Under a mesh (``register(..., sharding=policy)``, one process per
    rank, every rank registering the same tenants in the same order) the
    tenants dispatch through the mesh's one dispatch stream
    (``engine/controller.py``): the pool's threads on the controller rank
    never interleave two tenants' collectives, and the followers replay
    every tenant's operations in the controller's order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy
from repro_torch.engine import runtime as _runtime
from repro_torch.engine import serving as _serving
from repro_torch.engine.artifact import IndexArtifact
from repro_torch.engine.engine import RkMIPSEngine


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission and execution limits of one tenant.

    max_k          largest k a ticket may ask for (None: the config's).
    max_in_flight  cap on unresolved tickets; a submit past it is refused.
    scan_budget    per-query cap on reverse execute tile visits
                   (``EngineConfig.scan_budget``; 0 = uncapped).
    deadline       default per-ticket budget in seconds (None: none).
    """

    max_k: int | None = None
    max_in_flight: int | None = None
    scan_budget: int = 0
    deadline: float | None = None

    def __post_init__(self):
        if self.max_k is not None and self.max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {self.max_k}")
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got "
                             f"{self.max_in_flight}")
        if self.scan_budget < 0:
            raise ValueError(f"scan_budget must be >= 0 (0 = uncapped), "
                             f"got {self.scan_budget}")


class GatewayStats(NamedTuple):
    """``ServingGateway.stats()``: ``tenants``, each tenant's
    ``RuntimeStats``; ``traces_after_warmup``, the signatures added since
    ``warmup()`` summed over distinct share groups (before any warmup,
    all of them)."""

    tenants: dict
    traces_after_warmup: int


class _Tenant(NamedTuple):
    runtime: _runtime.ServingRuntime
    policy: TenantPolicy
    mode: str                  # "forward" | "reverse"
    traces: set                # the share group's signature set


class ServingGateway:
    """N tenants, one worker pool, one signature cache (module docstring).

    pool_workers   dispatch threads shared by every tenant.
    poll_interval  the pool's idle wakeup (seconds).
    """

    def __init__(self, *, pool_workers: int = 1,
                 poll_interval: float = 0.01):
        self.pool = _runtime.WorkerPool(pool_workers,
                                        poll_interval=poll_interval)
        self._tenants: dict[str, _Tenant] = {}
        self._fingerprints: dict[str, str] = {}
        self._group_base: dict[int, tuple[set, int]] = {}
        self._closed = False

    # -- registration ------------------------------------------------------

    def _share_donor(self, config, device, sharding: ShardingPolicy,
                     mode: str):
        """The first tenant this one can adopt a dispatch from: the same
        mode, device and mesh (``gateway.py:135-155``) and, for reverse
        tenants, a config equal in every field but ``scan_budget``."""
        for t in self._tenants.values():
            if t.mode != mode:
                continue
            donor = (t.runtime.server.engine if mode == "reverse"
                     else t.runtime.server)
            if donor.device != device or donor.policy.mesh is not \
                    sharding.mesh:
                continue
            if mode == "reverse" and donor.config.replace(
                    scan_budget=config.scan_budget) != config:
                continue
            return donor
        return None

    def register(self, name: str, artifact: IndexArtifact, *,
                 policy: TenantPolicy | None = None, k: int | None = None,
                 sharding: ShardingPolicy | None = None, mode: str = "auto",
                 **runtime_kwargs):
        """Bind ``name`` to an artifact version and a policy; returns the
        tenant's ``ServingRuntime``. ``mode`` is "reverse", "forward" or
        "auto" (reverse iff the artifact has users). Keyword args go to
        ``ServingRuntime``, which the gateway pools: never pass ``pool``,
        ``workers`` or ``deadline``. ``sharding``: the ``ShardingPolicy``
        the tenant serves under (None: single-device); under a mesh the
        artifact must be on the rank's device."""
        if self._closed:
            raise RuntimeError("gateway is closed: no new tenants")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} is already registered; "
                             f"swap(name, artifact) replaces its version")
        sharding = NO_SHARDING if sharding is None else sharding
        policy = TenantPolicy() if policy is None else policy
        if mode == "auto":
            mode = "reverse" if artifact.users is not None else "forward"
        if mode not in ("forward", "reverse"):
            raise ValueError(f"mode must be 'auto', 'forward' or "
                             f"'reverse', got {mode!r}")
        if mode == "reverse" and artifact.users is None:
            raise ValueError(
                f"tenant {name!r}: mode='reverse' needs an artifact built "
                f"for RkMIPS (users=None in this one)")
        for bad in ("pool", "workers", "deadline"):
            if bad in runtime_kwargs:
                raise ValueError(f"register() manages {bad!r} itself: the "
                                 f"pool is gateway-wide and the deadline "
                                 f"comes from TenantPolicy")

        cfg = artifact.config.replace(scan_budget=policy.scan_budget)
        donor = self._share_donor(cfg, artifact.device, sharding, mode)
        if mode == "reverse":
            engine = RkMIPSEngine(cfg, policy=sharding, device=artifact.device,
                                  share_dispatch=donor).attach(artifact)
            server = _serving.ReverseServer(engine)
            traces = engine._sigs
        else:
            if policy.scan_budget:
                raise ValueError(
                    f"tenant {name!r}: scan_budget is a reverse-pipeline "
                    f"knob (the forward scan has no execute loop to cap)")
            server = _serving.RetrievalServer.from_artifact(
                artifact, policy=sharding, share_dispatch=donor)
            traces = server._sigs
        rt = _runtime.ServingRuntime(server, k=k, pool=self.pool,
                                     deadline=policy.deadline,
                                     **runtime_kwargs)
        self._tenants[name] = _Tenant(rt, policy, mode, traces)
        self._fingerprints[name] = artifact.fingerprint
        return rt

    # -- routing and admission ---------------------------------------------

    def _entry(self, tenant: str) -> _Tenant:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}: registered tenants are "
                f"{sorted(self._tenants)}") from None

    def route(self, tenant: str) -> str:
        """The fingerprint of the version ``tenant`` is served from."""
        self._entry(tenant)
        return self._fingerprints[tenant]

    def submit(self, tenant: str, q, *, k: int | None = None, **kwargs):
        """Admit a query for ``tenant`` -> ``ServeTicket`` (one per row of
        a block), refusing an unknown tenant (``KeyError``), a k above the
        policy's ``max_k`` (``ValueError``) or a submit past
        ``max_in_flight`` (``RuntimeError``); the rest is the tenant
        runtime's ``submit``."""
        t = self._entry(tenant)
        ask = t.runtime._default_k if k is None else k
        if t.policy.max_k is not None and ask is not None \
                and ask > t.policy.max_k:
            raise ValueError(f"tenant {tenant!r}: k={ask} exceeds policy "
                             f"max_k={t.policy.max_k}")
        if t.policy.max_in_flight is not None \
                and t.runtime.pending >= t.policy.max_in_flight:
            raise RuntimeError(
                f"tenant {tenant!r}: {t.runtime.pending} tickets in "
                f"flight >= policy max_in_flight="
                f"{t.policy.max_in_flight}; resolve or drain first")
        return t.runtime.submit(q, k=k, **kwargs)

    # -- warmup and stats --------------------------------------------------

    def warmup(self, ks=None) -> int:
        """Warm one member of each share group at the union of the group's
        default ks (and ``ks``), then re-baseline every tenant. Returns
        the number of cells run."""
        groups: dict[int, tuple[_Tenant, set]] = {}
        for t in self._tenants.values():
            _, want = groups.setdefault(id(t.traces), (t, set()))
            if t.runtime._default_k is not None:
                want.add(t.runtime._default_k)
            if ks is not None:
                want.update(ks)
        cells = 0
        for rep, want in groups.values():
            if want:
                cells += rep.runtime.warmup(sorted(want))
        self._group_base = {gid: (rep.traces, len(rep.traces))
                            for gid, (rep, _) in groups.items()}
        for t in self._tenants.values():
            t.runtime.rebaseline_traces()
        return cells

    def stats(self) -> GatewayStats:
        """Each tenant's ``RuntimeStats`` and the gateway-wide signatures
        added since the last ``warmup()``."""
        if self._group_base:
            traces = sum(len(s) - base
                         for s, base in self._group_base.values())
        else:
            traces = sum(len(s) for s in {id(t.traces): t.traces
                                          for t in self._tenants.values()
                                          }.values())
        return GatewayStats(
            tenants={name: t.runtime.stats
                     for name, t in self._tenants.items()},
            traces_after_warmup=traces)

    # -- per-tenant lifecycle ----------------------------------------------

    def runtime(self, tenant: str) -> _runtime.ServingRuntime:
        """The tenant's ``ServingRuntime``."""
        return self._entry(tenant).runtime

    def swap(self, tenant: str, artifact: IndexArtifact) -> None:
        """Make a new version live for ``tenant`` (between its flushes);
        routing follows."""
        self._entry(tenant).runtime.swap(artifact)
        self._fingerprints[tenant] = artifact.fingerprint

    def insert_items(self, tenant: str, rows) -> IndexArtifact:
        """Stage rows on ``tenant``'s live version; returns (and routes
        to) the new version."""
        art = self._entry(tenant).runtime.insert_items(rows)
        self._fingerprints[tenant] = art.fingerprint
        return art

    def delete_items(self, tenant: str, ids) -> IndexArtifact:
        """Retire rows on ``tenant``'s live version; returns (and routes
        to) the new version."""
        art = self._entry(tenant).runtime.delete_items(ids)
        self._fingerprints[tenant] = art.fingerprint
        return art

    def request_compaction(self, tenant: str) -> None:
        """Ask ``tenant``'s maintenance thread for a compaction now (the
        tenant must be registered with ``compaction=True``)."""
        self._entry(tenant).runtime.request_compaction()

    # -- lifecycle ---------------------------------------------------------

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every tenant's admitted tickets have resolved."""
        ok = True
        for t in self._tenants.values():
            ok = t.runtime.drain(timeout) and ok
        return ok

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        """Close every tenant runtime (optionally draining), then the
        pool. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for t in self._tenants.values():
            t.runtime.close(drain=drain, timeout=timeout)
        self.pool.close()

    def __enter__(self) -> "ServingGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
