"""Continuous scanning (reference: ``trivy_tpu/watch/``): the
watch/admission counters the scan server reports. The watch loop and
the admission webhook are ROADMAP A.9g."""
