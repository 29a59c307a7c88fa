from .dtypes import DEFAULT_POLICY, FP32_POLICY, Policy, resolve_device

__all__ = ["Policy", "DEFAULT_POLICY", "FP32_POLICY", "resolve_device"]
