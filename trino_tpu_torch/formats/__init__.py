"""From-scratch Parquet and ORC readers and writers (host NumPy decode)."""
