"""Fault-injection plane, after the JAX package's ``utils/failpoints.py``:
named failpoint sites on the server's seams.

Sites are registered once at module import and fired at the seam; a
disarmed site costs one attribute read. The port registers the
single-node sites and the static cluster's (with the API):

=====================  ====================================================
``api.status``         the ``/status`` answer: arming ``error`` makes this
                       node look dead to a prober without stopping its
                       data plane.
``api.query``          the query entry of this node: arming ``error``
                       fails every query routed here.
``client.connect``     an internal RPC's connect (refused, partitioned).
``client.read``        an internal RPC's connection lost mid-flight.
``client.5xx``         an internal RPC answered 500.
``client.torn_body``   an internal RPC's response torn (``error``) or
                       lost after the peer acted (``drop``).
``heartbeat.probe``    one heartbeat probe: ``error`` fails it, ``drop``
                       loses it with no verdict.
=====================  ====================================================

The resize pull's site comes with resize.

Spec syntax (env ``PILOSA_TPU_FAILPOINTS``, the ``[failpoints]`` config
table, ``POST /internal/failpoints``)::

    site=mode[(arg)][xN] [; site=... ]

    api.query=error                     # every fire raises
    api.query=errorx2                   # the first 2 fires raise
    api.status=delay(1.5)               # sleep 1.5 s per fire
    api.query=partition(:10102)         # raise only when the fire's
                                        # uri/url contains ":10102"
    api.query=drop                      # raise FailpointDrop

Modes: ``error`` raises :class:`FailpointError` (a ``ConnectionError``);
``drop`` raises :class:`FailpointDrop`; ``delay(seconds)`` sleeps and
continues; ``partition(substr)`` raises only when the fire context's
``uri``/``url`` contains ``substr``.

The HTTP surface is test-only: ``cli/main.py`` enables it when any
failpoint configuration is present at boot; a server that never opted
in answers 403.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional

from pilosa_tpu_torch.utils.locks import make_lock

ENV_VAR = "PILOSA_TPU_FAILPOINTS"


class FailpointError(ConnectionError):
    """An injected failure. Subclasses ConnectionError so the client
    seams it fires on treat it exactly like a real transport error."""


class FailpointDrop(FailpointError):
    """An injected silent loss: sites that can drop an operation
    (heartbeat probes) swallow it; everywhere else it is an error."""


_SPEC_RE = re.compile(
    r"^(?P<mode>error|drop|delay|partition)"
    r"(?:\((?P<arg>[^)]*)\))?"
    r"(?:x(?P<count>\d+))?$")


class _Spec:
    __slots__ = ("mode", "arg", "remaining", "raw")

    def __init__(self, mode: str, arg: str, remaining: int,
                 raw: str) -> None:
        self.mode = mode
        self.arg = arg
        self.remaining = remaining  # fires left; -1 = unlimited
        self.raw = raw


def parse_spec(text: str) -> _Spec:
    m = _SPEC_RE.match(text.strip())
    if m is None:
        raise ValueError(f"bad failpoint spec {text!r} (expected "
                         f"mode[(arg)][xN], mode in error/drop/delay/"
                         f"partition)")
    mode = m.group("mode")
    arg = m.group("arg") or ""
    if mode == "delay":
        try:
            float(arg or "x")
        except ValueError:
            raise ValueError(
                f"delay spec needs numeric seconds: {text!r}") from None
    if mode == "partition" and not arg:
        raise ValueError(
            f"partition spec needs a URI substring: {text!r}")
    count = m.group("count")
    return _Spec(mode, arg, int(count) if count else -1, text.strip())


class Site:
    """One registered failpoint site. ``spec`` is None when disarmed —
    the ONLY state the hot path reads."""

    __slots__ = ("name", "spec", "hits", "_registry")

    def __init__(self, name: str, registry: "FailpointRegistry") -> None:
        self.name = name
        self.spec: Optional[_Spec] = None
        self.hits = 0
        self._registry = registry

    def fire(self, **ctx: Any) -> None:
        """Evaluate the site. Disarmed: one attribute read, return.
        Armed: sleep (delay), raise FailpointError (error /
        partition-on-match) or FailpointDrop (drop). Count-limited
        specs self-disarm after their last fire."""
        spec = self.spec
        if spec is None:
            return
        self._registry._fire(self, spec, ctx)


class FailpointRegistry:
    """Process-wide site registry. Sites register at module import
    (exactly once); activation comes from the env, the
    ``[failpoints]`` config table, or the test-only HTTP surface."""

    def __init__(self) -> None:
        self._lock = make_lock("FailpointRegistry._lock")
        self._sites: Dict[str, Site] = {}
        # Test-only HTTP surface gate (POST /internal/failpoints):
        # cli/main.py sets this when any failpoint config is present at
        # boot; in-process tests set it directly.
        self.http_enabled = False
        self.fired_total = 0

    # ------------------------------------------------------- registration

    def register(self, name: str) -> Site:
        """Register a site name (module-import time). Raises on
        duplicates: two sites sharing a name would make arm() ambiguous
        and the catalog a lie."""
        with self._lock:
            if name in self._sites:
                raise ValueError(f"failpoint {name!r} registered twice")
            site = Site(name, self)
            # graftlint: disable=GL008 — bounded by the static site
            # catalog: register() runs once per site at module import
            # (GL013 pins exactly-once), never on a request path.
            self._sites[name] = site
            return site

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._sites)

    # --------------------------------------------------------- activation

    def arm(self, name: str, spec: str) -> None:
        parsed = parse_spec(spec)
        with self._lock:
            site = self._sites.get(name)
            if site is None:
                raise KeyError(f"unknown failpoint {name!r} "
                               f"(registered: {sorted(self._sites)})")
            site.spec = parsed

    def disarm(self, name: str) -> None:
        with self._lock:
            site = self._sites.get(name)
            if site is None:
                raise KeyError(f"unknown failpoint {name!r}")
            site.spec = None

    def disarm_all(self) -> None:
        with self._lock:
            for site in self._sites.values():
                site.spec = None

    def configure(self, mapping: Optional[Dict[str, str]] = None,
                  env: Optional[str] = None) -> None:
        """Boot-time activation: a ``[failpoints]`` config table and/or
        the ``PILOSA_TPU_FAILPOINTS`` env string
        (``site=spec;site=spec``). Env wins on conflicts, matching the
        config precedence everywhere else. Unknown site names raise —
        a typo must not silently disarm a chaos run."""
        specs: Dict[str, str] = dict(mapping or {})
        text = os.environ.get(ENV_VAR, "") if env is None else env
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad {ENV_VAR} entry {part!r} (want site=spec)")
            name, spec = part.split("=", 1)
            specs[name.strip()] = spec.strip()
        for name, spec in specs.items():
            self.arm(name, str(spec))

    # -------------------------------------------------------------- fire

    def _fire(self, site: Site, spec: _Spec, ctx: Dict[str, Any]) -> None:
        if spec.mode == "partition":
            target = str(ctx.get("uri") or ctx.get("url") or "")
            if spec.arg not in target:
                return
        with self._lock:
            # Re-read under the lock: a concurrent disarm wins.
            if site.spec is not spec:
                return
            if spec.remaining == 0:
                site.spec = None
                return
            if spec.remaining > 0:
                spec.remaining -= 1
                if spec.remaining == 0:
                    site.spec = None
            site.hits += 1
            self.fired_total += 1
        if spec.mode == "delay":
            time.sleep(float(spec.arg))
            return
        if spec.mode == "drop":
            raise FailpointDrop(f"failpoint {site.name}: drop")
        raise FailpointError(
            f"failpoint {site.name}: {spec.mode}"
            + (f"({spec.arg})" if spec.arg else ""))

    # --------------------------------------------------------- reporting

    def snapshot(self) -> Dict[str, Any]:
        """The GET /internal/failpoints document + the health-plane
        stanza: every registered site, its armed spec (or null) and
        cumulative hit count."""
        with self._lock:
            sites = {
                name: {"armed": s.spec.raw if s.spec else None,
                       "hits": s.hits}
                for name, s in sorted(self._sites.items())
            }
            armed = sum(1 for s in self._sites.values()
                        if s.spec is not None)
            return {"sites": sites, "armed": armed,
                    "fired": self.fired_total}


FAILPOINTS = FailpointRegistry()
