"""Kubernetes API access (the port's copy of ``opsagent_tpu/k8s``)."""

from .client import K8sClient, KubeConfig, apply_yaml, get_kube_config, get_yaml

__all__ = ["K8sClient", "KubeConfig", "get_kube_config", "get_yaml", "apply_yaml"]
