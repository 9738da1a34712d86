"""Process-level parallelism of the port: the spawn-context worker pool
of the pooled index build (`procpool.py`)."""
