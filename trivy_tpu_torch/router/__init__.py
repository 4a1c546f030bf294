"""The scan router's pieces the scan server already uses (reference:
``trivy_tpu/router/``): the consistent-hash ring (``ring.py``) and the
lifecycle counters and planners (``lifecycle.py``). The router front,
its health prober and its scaler are ROADMAP A.9h.2."""
