"""Seeded synthetic registry (copied from ``trivy_tpu/soak/registry.py``):
a content-addressed layer graph with realistic reuse, scaled to
10⁵–10⁶ *distinct* layer identities.

The reference's warm fleet (``bench.py make_warm_fleet``) materializes
tarballs where ~80% of layers are drawn from a shared pool — the
reuse pattern that makes content-addressed memoization pay. That
works to a few hundred images; a million-image registry cannot touch
disk. This generator keeps the same reuse *shape* but is index-bound:
every manifest is a pure function of ``(seed, image index)``, layer
digests are derived identities, and nothing exists until the run
asks for it — corpus size costs an integer, not a filesystem.

The outputs speak the tree's existing protocols verbatim:

* :meth:`SyntheticRegistry.notification` emits Docker Registry v2
  push envelopes that ``watch.source.parse_notification`` accepts
  unchanged — tag-push streams feed the watch loop's
  ``WebhookSource`` directly;
* :meth:`SyntheticRegistry.scan_body` emits the twirp ``Scan`` body
  the router keys and the sim replica warms on (``blob_ids[0]`` is
  the base layer — the consistent-hash route key);
* :meth:`SyntheticRegistry.resolver` is a ``watch.source`` resolver
  mapping refs to virtual ``soak://`` targets the soak runner
  resolves back through the registry.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from ..watch.source import MANIFEST_MEDIA_TYPES

# virtual scan-target scheme: the soak runner's submit path resolves
# these back through the registry index instead of the filesystem
PATH_SCHEME = "soak://"


@dataclass(frozen=True)
class RegistrySpec:
    """Shape of the synthetic registry — all derivation is seeded,
    so two specs with equal fields ARE the same registry."""

    seed: int = 20260807
    layers: int = 100_000        # distinct layer identities
    images: int = 20_000         # distinct manifests
    reuse: float = 0.8           # share of layer slots drawn from
                                 # the hot base pool (the warm fleet's ratio)
    max_layers_per_image: int = 12
    tenants: tuple = ("acme", "globex", "initech")
    # popularity weights for the tenant mix (normalized on use)
    tenant_weights: tuple = (6, 3, 1)
    # fraction of images that are hostile (guard-quarantine trickle)
    hostile_rate: float = 0.0

    def __post_init__(self):
        if self.layers < 1 or self.images < 1:
            raise ValueError("layers and images must be >= 1")
        if not 0.0 <= self.reuse <= 1.0:
            raise ValueError(f"reuse {self.reuse} not in [0, 1]")
        if len(self.tenants) != len(self.tenant_weights):
            raise ValueError("one weight per tenant required")


class SyntheticRegistry:
    """Index-bound content-addressed registry over a RegistrySpec.

    ``manifest(i)`` is deterministic and cheap; the only growing
    state is the digest→index map for manifests a run actually
    emitted (bounded by distinct images touched, and sampled by the
    leak audit)."""

    def __init__(self, spec: RegistrySpec = None):
        self.spec = spec or RegistrySpec()
        s = self.spec
        # the hot base pool: small relative to the identity space,
        # skewed so low indices are most popular (alpine/debian base
        # layers in real registries)
        self.base_pool = max(4, min(s.layers // 64, 4096))
        self._by_digest: dict = {}   # manifest digest -> image index

    # ---- derived identities ----

    def layer_digest(self, j: int) -> str:
        return "sha256:" + hashlib.sha256(
            f"{self.spec.seed}:layer:{j}".encode()).hexdigest()

    def _image_rng(self, i: int) -> random.Random:
        return random.Random(
            f"{self.spec.seed}:image:{i}".encode())

    def layers_for(self, i: int) -> tuple:
        """The layer-digest tuple of image ``i``: the first slot and
        ``reuse`` of the rest come from the popularity-skewed base
        pool; the remainder are image-unique identities drawn from
        the full space — so distinct-layer count scales with
        ``spec.layers`` while cross-image reuse stays realistic."""
        s = self.spec
        rng = self._image_rng(i)
        n = 1 + rng.randrange(s.max_layers_per_image)
        out = []
        unique_space = max(1, s.layers - self.base_pool)
        for slot in range(n):
            if slot == 0 or rng.random() < s.reuse:
                # popularity skew: square the draw so low indices
                # dominate (the shared base-image pattern)
                j = int(rng.random() ** 2 * self.base_pool)
            else:
                j = self.base_pool + \
                    (i * s.max_layers_per_image + slot) \
                    % unique_space
            out.append(self.layer_digest(j))
        # a manifest never lists the same layer twice
        seen: set = set()
        return tuple(d for d in out
                     if not (d in seen or seen.add(d)))

    def tenant_for(self, i: int) -> str:
        s = self.spec
        rng = self._image_rng(i)
        total = sum(s.tenant_weights)
        pick = rng.random() * total
        for t, wt in zip(s.tenants, s.tenant_weights):
            pick -= wt
            if pick < 0:
                return t
        return s.tenants[-1]

    def is_hostile(self, i: int) -> bool:
        if self.spec.hostile_rate <= 0:
            return False
        return self._image_rng(i).random() < self.spec.hostile_rate

    def manifest(self, i: int) -> dict:
        """Image ``i`` as a manifest record. Content-addressed: the
        digest is the sha256 of the canonical layer list + repo, so
        identical content always carries the identical identity."""
        s = self.spec
        i = i % s.images
        layers = self.layers_for(i)
        tenant = self.tenant_for(i)
        repo = f"{tenant}/app-{i % max(1, s.images // 8)}"
        digest = "sha256:" + hashlib.sha256(
            ("\n".join(layers) + "\n" + repo).encode()).hexdigest()
        self._by_digest[digest] = i
        return {"index": i, "repository": repo,
                "tag": f"v{i % 7}", "digest": digest,
                "tenant": tenant, "layers": layers,
                "hostile": self.is_hostile(i)}

    def by_digest(self, digest: str) -> dict:
        """Manifest for a digest this registry emitted. Raises
        KeyError for digests it never minted (a malformed or foreign
        event — the watch loop sheds it as unresolvable)."""
        return self.manifest(self._by_digest[digest])

    # ---- protocol adapters ----

    def notification(self, i: int, event_id: str = "",
                     traceparent: str = "") -> dict:
        """One Docker Registry v2 push-notification envelope for
        image ``i`` — byte-compatible with
        ``watch.source.parse_notification``."""
        m = self.manifest(i)
        doc = {"events": [{
            "id": event_id or f"soak-{self.spec.seed}-{i}",
            "action": "push",
            "target": {"mediaType": MANIFEST_MEDIA_TYPES[0],
                       "repository": m["repository"],
                       "tag": m["tag"],
                       "digest": m["digest"]}}]}
        if traceparent:
            doc["traceparent"] = traceparent
        return doc

    def resolver(self):
        """A ``watch.source`` resolver: refs resolve to virtual
        ``soak://<digest>`` targets (only for digests this registry
        minted — anything else is unresolvable and sheds)."""
        def resolve(ref: str, digest: str = ""):
            if digest in self._by_digest:
                return PATH_SCHEME + digest
            return ""
        return resolve

    def resolve_path(self, path: str) -> dict:
        """``soak://<digest>`` → manifest (KeyError if foreign)."""
        if not path.startswith(PATH_SCHEME):
            raise KeyError(path)
        return self.by_digest(path[len(PATH_SCHEME):])

    def scan_body(self, manifest: dict,
                  idempotency_key: str = "") -> dict:
        """The twirp ``Scan`` body for one manifest — same shape as
        the router bench's requests, so route keys, sim warm state
        and idempotent replay behave identically."""
        body = {"idempotency_key": idempotency_key,
                "target": f"{manifest['repository']}:"
                          f"{manifest['tag']}",
                "artifact_id": "sha256:art-"
                               + manifest["digest"][-12:],
                "blob_ids": list(manifest["layers"]),
                "tenant": manifest["tenant"]}
        if manifest.get("hostile"):
            body["hostile"] = True
        return body

    def stats(self) -> dict:
        """Reuse/shape sample for reports (deterministic for a given
        spec): distinct layers across the first 256 manifests, and
        the measured base-pool share."""
        s = self.spec
        sample = min(256, s.images)
        distinct: set = set()
        slots = base_hits = 0
        base = {self.layer_digest(j)
                for j in range(self.base_pool)}
        for i in range(sample):
            for d in self.layers_for(i):
                distinct.add(d)
                slots += 1
                if d in base:
                    base_hits += 1
        return {"images": s.images, "layers": s.layers,
                "base_pool": self.base_pool,
                "sample_images": sample,
                "sample_distinct_layers": len(distinct),
                "sample_base_share":
                    round(base_hits / max(1, slots), 4),
                "indexed_digests": len(self._by_digest)}
