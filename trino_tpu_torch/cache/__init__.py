"""The coordinator's semantic result cache (``result_cache.py``)."""

from trino_tpu_torch.cache.result_cache import ResultCache

__all__ = ["ResultCache"]
