from .pipeline import EOS, DataConfig, Prefetcher, TokenSource, to_device

__all__ = ["EOS", "DataConfig", "Prefetcher", "TokenSource", "to_device"]
