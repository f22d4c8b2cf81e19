from .precision import exact_fp32, resolve_device

__all__ = ["exact_fp32", "resolve_device"]
