"""The scan router's pieces the scan server already books into
(reference: ``trivy_tpu/router/``): the lifecycle counters. The
router, its ring and its scaler are ROADMAP A.9h."""
