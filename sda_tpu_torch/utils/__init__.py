from .metrics import Metrics, get_metrics, torch_trace

__all__ = ["Metrics", "get_metrics", "torch_trace"]
