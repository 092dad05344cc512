"""Multi-device and multi-process encode (parallel/sharding.py, parallel/multihost.py)."""
