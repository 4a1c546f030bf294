"""Advisory database: the trivy-db bucket schema, flattened for batch
detection.

Reference schema (trivy-db): top-level buckets per source
(``alpine 3.10``, ``debian 11``, ``pip::…``) → nested bucket per
package → key = CVE id, value = JSON advisory; plus a
``vulnerability`` bucket keyed by CVE id with severity/CVSS detail,
and ``data-source`` metadata.
"""

from .store import Advisory, AdvisoryStore, VulnerabilityDetail
from .fixtures import load_fixtures
from .compiled import CompiledDB

__all__ = ["Advisory", "AdvisoryStore", "VulnerabilityDetail",
           "load_fixtures", "CompiledDB"]
