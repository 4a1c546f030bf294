"""Kubernetes image helpers (copied from ``trivy_tpu/k8s/__init__.py``:
``_pod_spec``, ``_images``, ``images_from_object``, ``_sanitize_ref``
and ``resolve_image_ref``).

Only the helpers that the continuous-scanning front-ends share are
here: the admission webhook (``watch/admission.py``) reads the images
of a reviewed object with :func:`images_from_object`, and the
``--images-dir`` resolvers (``watch/source.py::dir_resolver``) map a
ref to a local tarball with :func:`resolve_image_ref`. The cluster
scanner (``K8sScanner``, ``ManifestClient``, the report) and the
``k8s`` subcommand are ROADMAP A.9j.
"""

from __future__ import annotations

import os
import re
from typing import Optional

# workload kinds that carry pod specs (trivy-kubernetes artifacts.go)
WORKLOAD_KINDS = ("Pod", "Deployment", "StatefulSet", "DaemonSet",
                  "ReplicaSet", "ReplicationController", "Job",
                  "CronJob")


def _pod_spec(doc: dict) -> dict:
    spec = doc.get("spec") or {}
    if doc.get("kind") == "CronJob":
        spec = ((spec.get("jobTemplate") or {}).get("spec") or {})
    return ((spec.get("template") or {}).get("spec")) or spec


def _images(doc: dict) -> list:
    pod = _pod_spec(doc)
    return [c.get("image", "")
            for key in ("initContainers", "containers")
            for c in pod.get(key) or [] if c.get("image")]


def images_from_object(doc: dict) -> list:
    """Pod-spec image references of one workload object — bare Pods
    and every templated WORKLOAD_KIND alike, as the reference's
    cluster scanner and admission webhook read them."""
    if not isinstance(doc, dict):
        return []
    return _images(doc)


def _sanitize_ref(ref: str) -> str:
    return re.sub(r"[/:@]", "_", ref)


def resolve_image_ref(images_dir: str, ref: str) -> Optional[str]:
    """image ref → local tarball named ``<ref with /:@ as _>.tar``
    (the zero-egress stand-in for a registry pull). Every ``/`` of the
    ref becomes ``_``, so a ref never names a path outside
    ``images_dir``."""
    if not images_dir:
        return None
    for cand in (f"{_sanitize_ref(ref)}.tar",
                 f"{_sanitize_ref(ref.split('/')[-1])}.tar"):
        path = os.path.join(images_dir, cand)
        if os.path.exists(path):
            return path
    return None
